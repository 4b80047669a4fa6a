"""The resident SS2 step of the port (K13, ops/cuda/resident2d.py) against
the JAX package's (ops/pallas/resident2d.py, in Pallas interpret mode, as
tests/test_resident.py runs it) and against the port's own eigh path.

Inputs are made with numpy from a seed and given to both sides.
Tolerances:
* one step of the plain version against the Pallas kernel, and 3 steps of
  nlse_problem with resident_mode "auto" on both sides: rel-L2 <= 1e-5.
  Both sides are float32 and run the same algorithm in the same order of
  operations; only the summation order of the dots differs.
* the resident step against the port's eigh path (one step): rel-L2 <=
  1e-5. The Taylor series is truncated below 1e-8, so what is left is
  float32 rounding.
* the recurrence the kernel follows (the kick, the pipelined Lanczos loop
  _lanczos_pipe, the Taylor series, the combine, the kick and the ghost
  ring), composed from the port's plain pieces in float64, against the
  Pallas kernel: rel-L2 <= 1e-5, the same algorithm up to the rounding of
  the float32 side.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu.ops.pallas import resident2d as jr
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.boundaries import neumann_no_velocity_2d
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import resident2d as tr
from nlsolvers_tpu_torch.utils import interop

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (16, 128)          # the smallest grid JAX's TPU gates take
PARAMS = {"cubic": {}, "cubic_quintic": dict(sigma1=1.0, sigma2=-0.08),
          "saturable": dict(kappa=0.7)}


@pytest.fixture
def resident_on():
    """Both packages on their resident path; the JAX kernel interpreted."""
    old = jconfig.pallas_mode, jconfig.resident_mode
    jconfig.pallas_mode, jconfig.resident_mode = "interpret", "auto"
    old_t = interop.set_switches(
        **interop.switches_from_jax(jconfig, jl))
    yield
    jconfig.pallas_mode, jconfig.resident_mode = old
    interop.set_switches(**old_t)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u0(shape, seed=0):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    x = np.linspace(-5, 5, nx, dtype=np.float32)
    y = np.linspace(-5, 5, ny, dtype=np.float32)
    env = np.exp(-(y[:, None] ** 2 + x[None, :] ** 2) / 4)
    return (env * np.exp(0.3j * x[None, :])
            + 0.01 * rng.standard_normal(shape)).astype(np.complex64)


def _m_field(shape):
    ny, nx = shape
    return (1.0 + 0.2 * np.sin(np.linspace(0, 3, ny))[:, None]
            * np.ones((1, nx))).astype(np.float32)


@pytest.mark.parametrize("theta", [0.05, 0.5, 1.0, 2.09, 3.5, 6.0])
def test_taylor_degree_matches_jax(theta):
    d = tr._taylor_degree(theta)
    assert d == jr._taylor_degree(theta)
    assert theta ** (d + 1) / math.factorial(d + 1) < 1e-7 or d == 30


def test_supported_resident_matches_jax():
    """Where JAX's gates are numeric, both agree; its TPU-geometry gates
    (nx % 128, ny % 8, the basis within 112 MiB of VMEM) are dropped, so
    the port takes those grids and JAX does not."""
    dx = 0.1
    jd = jops.laplacian_2d(SHAPE, dx, dx, dtype=jnp.float32)._pallas_desc
    td = tops.laplacian_2d(SHAPE, dx, dx, device="cpu").kernel_desc
    for m, dt, dtype in ((10, 1e-4, "c64"), (10, 1.0, "c64"),
                         (10, 1e-4, "f32"), (10, 4.4e-3, "c64"),
                         (10, 4.3e-3, "c64")):
        want = jr.supported_resident(
            jd, SHAPE, jnp.complex64 if dtype == "c64" else jnp.float32, m,
            dt)
        got = tr.supported_resident(
            td, SHAPE, torch.complex64 if dtype == "c64" else torch.float32,
            m, dt)
        assert got == want, (m, dt, dtype)
    assert not tr.supported_resident(dict(td, variant="separated"), SHAPE,
                                     torch.complex64, 10, 1e-4)
    assert not tr.supported_resident(td, SHAPE, torch.complex64,
                                     tl.MAX_M + 1, 1e-4)
    # TPU geometry: JAX refuses, the port takes
    for shape in ((100, 100), (250, 333), (4096, 4096)):
        jd2 = jops.laplacian_2d(shape, dx, dx, dtype=jnp.float32)._pallas_desc
        td2 = tops.laplacian_2d(shape, dx, dx, device="cpu").kernel_desc
        assert not jr.supported_resident(jd2, shape, jnp.complex64, 10, 1e-6)
        assert tr.supported_resident(td2, shape, torch.complex64, 10, 1e-6)


@pytest.mark.parametrize("variant,apply_bc", [("reference", True),
                                              ("clean", False)])
@pytest.mark.parametrize("kind", ["cubic", "cubic_quintic", "saturable"])
def test_resident_step_ref_matches_pallas(kind, variant, apply_bc):
    m, dt = 6, 5e-4
    dx = 2 * 5.0 / (SHAPE[1] - 1)
    jd = jops.laplacian_2d(SHAPE, dx, dx, variant=variant,
                           dtype=jnp.float32)._pallas_desc
    td = tops.laplacian_2d(SHAPE, dx, dx, variant=variant,
                           device="cpu").kernel_desc
    z = _u0(SHAPE, 1)
    u = np.stack([z.real, z.imag]).astype(np.float32)
    mf = _m_field(SHAPE)
    want = jr.ss2_resident_step(jnp.asarray(u), jnp.asarray(mf), jd, dt, m,
                                kind=kind, apply_bc=apply_bc,
                                interpret=True, **PARAMS[kind])
    got = tr.ss2_resident_step(torch.from_numpy(u), torch.from_numpy(mf), td,
                               dt, m, kind=kind, apply_bc=apply_bc,
                               **PARAMS[kind])
    assert got.shape == (2,) + SHAPE
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_nlse_problem_resident_matches_jax(resident_on):
    """nlse_problem with resident_mode "auto" on both sides, 3 steps from
    the same numpy state; the port's state stays complex, as JAX's."""
    m, dt, kind = 8, 5e-4, "cubic"
    mf = _m_field(SHAPE)
    jp = jproblems.nlse_problem(kind, SHAPE, 5.0, dt, m_field=mf,
                                krylov_m=m, dtype=jnp.complex64)
    args, kwargs = interop.nlse_args_from_meta(jp.meta)
    tp = tproblems.nlse_problem(*args, m_field=mf, dtype=torch.complex64,
                                device="cpu", **kwargs)
    assert not jp.meta["planar_state"] and not tp.meta["planar_state"]
    z = jp.init(_u0(SHAPE, 2))
    step = jax.jit(jp.step)
    for i in range(1, 4):
        z = step(z, i)
    s = interop.state_from_numpy(np.asarray(jp.init(_u0(SHAPE, 2))), SHAPE,
                                 "cpu")
    before = tr.ss2_resident_step.launches
    for i in range(1, 4):
        s = tp.step(s, i)
    assert s.dtype == torch.complex64
    assert _rel(tp.observe(s).numpy(), np.asarray(z)) <= TOL
    assert tr.ss2_resident_step.launches == before     # CPU: plain version


def test_resident_matches_eigh_path():
    """One resident step against the port's planar SS2 step (Lanczos +
    eigh), at the headline theta ~ 2 and m = 10 on a ragged grid."""
    shape, m = (40, 56), 10
    dx = 2 * 5.0 / (shape[1] - 1)
    dt = 2.0 / (8.0 / dx ** 2)
    mf = _m_field(shape)
    u0 = _u0(shape, 3)
    old = config.resident_mode
    try:
        config.resident_mode = "auto"
        res = tproblems.nlse_problem("cubic", shape, 5.0, dt, m_field=mf,
                                     krylov_m=m, device="cpu")
    finally:
        config.resident_mode = old
    ref = tproblems.nlse_problem("cubic", shape, 5.0, dt, m_field=mf,
                                 krylov_m=m, device="cpu")
    assert ref.meta["planar_state"] and not res.meta["planar_state"]
    got = res.observe(res.step(res.init(u0), 1))
    want = ref.observe(ref.step(ref.init(u0), 1))
    assert _rel(got.numpy(), want.numpy()) <= TOL


def test_resident_off_and_unsupported_take_other_paths():
    """resident_mode "off" (the default), a two-step integrator, c(x), the
    radiating BC or a theta above 3.5 keep the earlier paths."""
    assert config.resident_mode == "off"
    old = config.resident_mode
    try:
        config.resident_mode = "auto"
        for kw in (dict(integrator="sewi"),
                   dict(c_field=np.ones((8, 9))), dict(bc="radiating"),
                   dict(dt=1.0)):
            kw = dict(dict(dt=1e-4), **kw)
            p = tproblems.nlse_problem("cubic", (8, 9), 5.0, kw.pop("dt"),
                                       krylov_m=4, device="cpu", **kw)
            s = p.step(p.init(_u0((8, 9))), 1)
            planar = p.meta["planar_state"]
            assert planar == (kw.get("bc") != "radiating"), kw
            assert (s[0] if isinstance(s, tuple) else s).dim() in (2, 3)
        config.resident_mode = "on"
        with pytest.raises(ValueError):
            tproblems.nlse_problem("cubic", (8, 9), 5.0, 1e-4, krylov_m=4,
                                   device="cpu")
    finally:
        config.resident_mode = old


def test_switches_carry_across():
    old = interop.set_switches(resident_mode="auto", pipeline_3d=True)
    try:
        assert (config.resident_mode, config.pipeline_3d) == ("auto", True)
        assert interop.switches_from_jax(jconfig, jl) == {
            "resident_mode": "off", "fused_iter": False,
            "pipeline_3d": False}
        with pytest.raises(ValueError):
            interop.set_switches(pallas_mode="on")
    finally:
        interop.set_switches(**old)
    assert (config.resident_mode, config.fused_iter,
            config.pipeline_3d) == ("off", False, False)


def _pipe_recurrence_f64(u, mf, desc, dt, m, kind, apply_bc, params):
    """One SS2 step as the kernel computes it, in float64 on the CPU: the
    kick, _lanczos_pipe (the default path's deferred-norm recurrence), the
    Taylor series of exp(i dt T) e1 in the kernel's order, the combine, the
    second kick (rho of the combined field) and the ghost ring."""
    s1, s2 = params.get("sigma1", 1.0), params.get("sigma2", -0.1)
    kappa = params.get("kappa", 1.0)
    u = torch.from_numpy(u).double()
    mf = torch.from_numpy(mf).double()
    half = 0.5 * dt
    w0 = torch.stack(tr._phase_mul(u[0], u[1], tr._rho(
        kind, mf, u[0], u[1], s1, s2, kappa), half))
    old = config.kernel_mode
    config.kernel_mode = "off"
    try:
        W, sv, alphas, betas, beta0 = tl._lanczos_pipe(w0, m, desc)
    finally:
        config.kernel_mode = old
    alpha = torch.zeros(m, dtype=torch.float64)
    beta = torch.zeros(max(m - 1, 0), dtype=torch.float64)
    for i, a in enumerate(alphas):
        alpha[i] = a
    for i, b in enumerate(betas):
        beta[i] = b
    tre = torch.zeros(m, dtype=torch.float64)
    tre[0] = 1.0
    tim = torch.zeros_like(tre)
    yre, yim = tre.clone(), tim.clone()
    for k in range(1, tr._taylor_degree(tr._theta(desc, dt)) + 1):
        ar, ai = alpha * tre, alpha * tim
        ar[1:] += beta * tre[:-1]
        ai[1:] += beta * tim[:-1]
        ar[:-1] += beta * tre[1:]
        ai[:-1] += beta * tim[1:]
        tre, tim = -(dt / k) * ai, (dt / k) * ar
        yre, yim = yre + tre, yim + tim
    outr = torch.zeros_like(w0[0])
    outi = torch.zeros_like(w0[1])
    for i in range(m):
        cr, ci = beta0 * sv[i] * yre[i], beta0 * sv[i] * yim[i]
        outr = outr + cr * W[i][0] - ci * W[i][1]
        outi = outi + cr * W[i][1] + ci * W[i][0]
    out = torch.stack(tr._phase_mul(outr, outi, tr._rho(
        kind, mf, outr, outi, s1, s2, kappa), half))
    return neumann_no_velocity_2d(out) if apply_bc else out


@pytest.mark.parametrize("kind,variant,apply_bc,m", [
    ("cubic", "reference", True, 10), ("cubic_quintic", "clean", False, 6),
    ("saturable", "reference", True, 2), ("cubic", "clean", True, 1)])
def test_pipe_recurrence_matches_pallas(kind, variant, apply_bc, m):
    """The recurrence K13 follows, in float64, against the Pallas kernel
    (two-pass Gram-Schmidt in float32, interpreted)."""
    dt = 5e-4
    dx = 2 * 5.0 / (SHAPE[1] - 1)
    jd = jops.laplacian_2d(SHAPE, dx, dx, variant=variant,
                           dtype=jnp.float32)._pallas_desc
    td = tops.laplacian_2d(SHAPE, dx, dx, variant=variant,
                           device="cpu").kernel_desc
    z = _u0(SHAPE, 4)
    u = np.stack([z.real, z.imag]).astype(np.float32)
    mf = _m_field(SHAPE)
    want = jr.ss2_resident_step(jnp.asarray(u), jnp.asarray(mf), jd, dt, m,
                                kind=kind, apply_bc=apply_bc,
                                interpret=True, **PARAMS[kind])
    got = _pipe_recurrence_f64(u, mf, td, dt, m, kind, apply_bc,
                               PARAMS[kind])
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_scratch_shapes():
    """The kernel's scratch: the basis, the two av columns it alternates
    between, and the partial sums the library asks for."""
    got = tr.scratch_shapes(10, 1024, 1024, 2 * 131 * 1056)
    assert got == {"basis": (10, 2, 1024, 1024), "avs": (2, 2, 1024, 1024),
                   "partial": (2 * 131 * 1056,)}
    assert tr.scratch_shapes(1, 5, 3, 7)["basis"] == (1, 2, 5, 3)
