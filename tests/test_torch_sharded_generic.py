"""The port's generic sharded path against the JAX package's, on the CPU.

complex128, reorth=False and the float64 or reorth=False real-wave
Gautschi run the generic sharded Lanczos: ops/krylov.py with a mesh (JAX's
axis_names), every dot and norm each shard's partial summed over the shards
in shard order, one tridiag_eigh on the reduced T, the steps of
models/nlse.py and models/realwave.py on complex (or real) per-shard blocks
with the plain sharded operators. JAX's side is its shard_map path on the 8
virtual CPU devices of tests/conftest.py; JAX psums in XLA's order, the
port in shard order, so the gates are JAX's, not its bits.

Gates:
* the sharded NLSE engine (SS2, sEWI, fused sEWI, Gautschi; 2D iso and
  c(x), 3D clean) in complex128 against JAX's: rtol 1e-10, atol 1e-12
  (tests/test_parallel.py's f64 gate), the mass series at rtol 1e-10;
  with reorth=False in complex64: rtol 2e-4, atol 2e-5 (JAX's complex64
  sharded gate);
* the complex128 sharded SS2 step against the unsharded complex128
  problem (JAX's test_sharded_nlse_step_matches_single_device): 1e-10 /
  1e-12;
* the float64 sharded real-wave Gautschi step and engine, u rtol 1e-10,
  atol 1e-12, v rtol 1e-8, atol 1e-10, and the energy series rtol 1e-10,
  against JAX's and the port's unsharded engine; float32 reorth=False at
  rtol 2e-4, atol 2e-5;
* the unsharded generic Krylov path bit for bit against the
  implementation it had before the mesh argument (kept here), and the
  sharded path on a one-shard mesh bit-equal to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu_torch.config import real_dtype_of
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import krylov as tk
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial
from nlsolvers_tpu_torch.pipeline import engine as teng

torch.set_num_threads(1)

N, LX, DT = 32, 4.0, 2e-3
AX2, AX3 = ("gy", "gx"), ("gz", "gy", "gx")
F64 = dict(rtol=1e-10, atol=1e-12)
C64 = dict(rtol=2e-4, atol=2e-5)


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _port_mesh(shape, axes):
    return tmesh.make_mesh(axes, shape, devices=["cpu"] * int(np.prod(shape)))


def _nlse_inputs(shape, B, seed, dtype):
    rng = np.random.default_rng(seed)
    x = [np.linspace(-1, 1, n) for n in shape]
    grid = np.meshgrid(*x, indexing="ij")
    env = np.exp(-sum(g ** 2 for g in grid) * 2.0)
    u0 = np.stack([env * np.exp(1j * (0.5 + 0.3 * b) * grid[-1])
                   + 0.02 * rng.standard_normal(shape) for b in range(B)])
    packed = np.stack([u0.real, u0.imag], axis=1).astype(dtype)
    m = (1.0 + 0.2 * rng.random((B,) + shape)).astype(dtype)
    c = (1.0 + 0.3 * rng.random((B,) + shape)).astype(dtype)
    return packed, m, c


# ------------------------------------------------------------ NLSE

@pytest.mark.parametrize("integrator,use_c,dim,reorth", [
    ("ss2", False, 2, True), ("sewi", True, 2, True),
    ("sewi_fused", True, 2, True), ("gautschi", False, 2, True),
    ("ss2", True, 3, True), ("ss2", True, 2, False),
    ("gautschi", False, 3, False)])
def test_sharded_nlse_engine_generic_matches_jax(integrator, use_c, dim,
                                                 reorth):
    """The generic sharded NLSE engine (guard and mass series on), B = 2:
    complex128 with reorth against JAX's complex128 engine at the f64 gate;
    complex64 with reorth=False at JAX's complex64 gate. 2D on (2, 2), 3D
    16^3 on (2, 1, 2) with the clean variant."""
    if dim == 2:
        shape, mshape, axes = (N, N), (2, 2), AX2
    else:
        shape, mshape, axes = (16, 16, 16), (2, 1, 2), AX3
    f64 = reorth
    npdt = np.float64 if f64 else np.float32
    packed, m, c = _nlse_inputs(shape, 2, 50 + dim, npdt)
    kw = dict(integrator=integrator, krylov_m=6, variant="clean",
              reorth=reorth, use_c=use_c, guard=True, record_energy=True)
    jout = jspatial.make_sharded_nlse_trajectory_fn(
        "cubic", shape, LX, DT, _jax_mesh(mshape, axes), axis_names=axes,
        dtype=jnp.complex128 if f64 else jnp.complex64, **kw)(
        packed, m, c, 3, 2)
    tfn = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", shape, LX, DT, _port_mesh(mshape, axes), axis_names=axes,
        dtype=torch.complex128 if f64 else torch.complex64, **kw)
    assert not tfn.batched
    snaps, bad_at, series = tfn(packed, m, c, 3, 2)
    assert snaps.shape == (2, 3, 2) + shape
    assert snaps.dtype == (torch.float64 if f64 else torch.float32)
    np.testing.assert_array_equal(snaps[:, 0].numpy(), packed)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(jout[0]),
                               **(F64 if f64 else C64))
    np.testing.assert_array_equal(bad_at.numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(series["mass"].numpy(),
                               np.asarray(jout[2]["mass"]),
                               rtol=1e-10 if f64 else 1e-5)


def test_sharded_nlse_step_complex128_matches_single_device():
    """JAX's test_sharded_nlse_step_matches_single_device on the port: the
    complex128 sharded SS2 step on (2, 2), 3 steps, against the unsharded
    complex128 nlse_problem; reorth=False on both sides too."""
    rng = np.random.default_rng(11)
    m = rng.uniform(0.5, 1.5, (N, N))
    env = np.exp(-(np.linspace(-1, 1, N)[:, None] ** 2
                   + np.linspace(-1, 1, N)[None, :] ** 2))
    u0 = (env * np.exp(1j * env)).astype(np.complex128)
    mesh = _port_mesh((2, 2), AX2)
    for reorth in (True, False):
        prob = tproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=m,
                                      krylov_m=8, dtype=torch.complex128,
                                      reorth=reorth, device="cpu")
        ref = prob.init(u0)
        for i in range(3):
            ref = prob.step(ref, i + 1)
        step = tspatial.make_sharded_nlse_step(
            "cubic", (N, N), LX, DT, mesh, krylov_m=8,
            dtype=torch.complex128, reorth=reorth)
        up, mp = shards.shard(np.stack([u0.real, u0.imag]), mesh), \
            shards.shard(m, mesh)
        for _ in range(3):
            up = step(up, mp)
        got = shards.gather(up, mesh).numpy()
        np.testing.assert_allclose(got[0] + 1j * got[1], ref.numpy(), **F64)


# ------------------------------------------------------------ real wave

def _rw_inputs(B, seed, dtype):
    rng = np.random.default_rng(seed)
    u0 = (0.3 * rng.standard_normal((B, N, N))).astype(dtype)
    v0 = (0.05 * rng.standard_normal((B, N, N))).astype(dtype)
    m = (1.0 + 0.1 * rng.random((B, N, N))).astype(dtype)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(dtype)
    return u0, v0, m, c


@pytest.mark.parametrize("kind,f64", [("sine_gordon", True),
                                      ("klein_gordon", True),
                                      ("sine_gordon", False)])
def test_sharded_realwave_engine_generic_matches_jax(kind, f64):
    """The sharded real-wave Gautschi engine on the generic path, c(x),
    2D on (2, 4), B = 2, guard and energy series on: float64 against JAX's
    float64 engine and the port's unsharded engine (u rtol 1e-10, the
    energy rtol 1e-10); float32 with reorth=False against JAX's at the
    float32 gates."""
    npdt = np.float64 if f64 else np.float32
    args = _rw_inputs(2, 60, npdt)
    kw = dict(integrator="gautschi", krylov_m=6, reorth=f64, guard=True,
              record_energy=True)
    ju, jv, jbad, jser = jspatial.make_sharded_realwave_trajectory_fn(
        kind, (N, N), LX, DT, _jax_mesh((2, 4), AX2), axis_names=AX2,
        dtype=jnp.float64 if f64 else jnp.float32, **kw)(*args, 3, 2)
    tdtype = torch.float64 if f64 else torch.float32
    tfn = tspatial.make_sharded_realwave_trajectory_fn(
        kind, (N, N), LX, DT, _port_mesh((2, 4), AX2), dtype=tdtype, **kw)
    assert not tfn.batched
    tu, tv, tbad, tser = tfn(*args, 3, 2)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    if not f64:
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **C64)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-3,
                                   atol=5e-3)
        return
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **F64)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(tser["energy"].numpy(),
                               np.asarray(jser["energy"]), rtol=1e-10)
    ru, _, rbad, rser = teng.make_realwave_trajectory_fn(
        kind, (N, N), LX, DT, dtype=tdtype, device="cpu", **kw)(*args, 3, 2)
    np.testing.assert_allclose(tu.numpy(), ru.numpy(), **F64)
    np.testing.assert_allclose(tser["energy"].numpy(),
                               rser["energy"].numpy(), rtol=1e-10)


def test_sharded_realwave_step_float64_gautschi_matches_jax():
    """make_sharded_realwave_step, one float64 Gautschi step of a 3D clean
    Klein-Gordon grid 16^3 on (2, 2, 2) against JAX's step."""
    rng = np.random.default_rng(61)
    shape = (16, 16, 16)
    u = 0.2 * rng.standard_normal(shape)
    up = u + 0.01 * rng.standard_normal(shape)
    m = 1.0 + 0.1 * rng.random(shape)
    jstep = jspatial.make_sharded_realwave_step(
        "klein_gordon", shape, LX, DT, _jax_mesh((2, 2, 2), AX3),
        axis_names=AX3, krylov_m=6, dtype=jnp.float64, variant="clean")
    jn, _ = (np.asarray(a) for a in jstep(u, up, m))
    mesh = _port_mesh((2, 2, 2), AX3)
    tstep = tspatial.make_sharded_realwave_step(
        "klein_gordon", shape, LX, DT, mesh, axis_names=AX3, krylov_m=6,
        dtype=torch.float64, variant="clean")
    tn, to = (shards.gather(x, mesh, AX3) for x in tstep(
        *(shards.shard(a, mesh, AX3) for a in (u, up, m))))
    np.testing.assert_array_equal(to.numpy(), u)
    np.testing.assert_allclose(tn.numpy(), jn, **F64)


# ------------------------------------------------------------ the Krylov core

def _old_matfunc_apply_multi(matvec, u, specs, m, reorth):
    """ops/krylov.matfunc_apply_multi's generic path as it was before the
    mesh argument."""
    rdtype = real_dtype_of(u.dtype)

    def gnorm(x):
        sq = x.real ** 2 + x.imag ** 2 if x.is_complex() else x ** 2
        return torch.sqrt(torch.sum(sq)).to(rdtype)

    def safe_div(x, nrm):
        return (x / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(
            u.dtype)

    beta0 = gnorm(u)
    vs = [safe_div(u, beta0)]
    n = u.numel()
    alphas, betas = [], []
    for j in range(m - 1):
        vj = vs[j]
        w = matvec(vj).to(u.dtype)
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        if reorth:
            Vm = torch.stack([v.reshape(n) for v in vs])
            proj = torch.matmul(Vm.conj(), w.reshape(n))
            a = proj[j].real.to(rdtype)
            w = w - torch.matmul(proj, Vm).reshape(u.shape)
        else:
            a = torch.sum(vj.conj() * w).real.to(rdtype)
            w = w - a * vj
        b = gnorm(w)
        vs.append(safe_div(w, b))
        alphas.append(a)
        betas.append(b)
    alpha, beta = tk.tridiag_entries(alphas, betas, beta0, m, rdtype)
    lam, Q = tk.tridiag_eigh(alpha, beta)
    outs = []
    for t, func in specs:
        coef = tk.coefficients(func, t, lam, Q, beta0).to(u.dtype)
        out = coef[0] * vs[0]
        for i in range(1, m):
            out = out + coef[i] * vs[i]
        outs.append(out.to(u.dtype))
    return tuple(outs)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64,
                                   torch.float64])
@pytest.mark.parametrize("reorth", [True, False])
@pytest.mark.parametrize("m", [1, 7])
def test_unsharded_generic_krylov_unchanged(dtype, reorth, m):
    """matfunc_apply_multi without a mesh keeps the bits of its generic
    path before the mesh argument (the operator carries no descriptor);
    on a one-shard mesh the sharded path gives the same bits; on (2, 2)
    the sharded generic run matches the unsharded one within 1e-12 in
    f64."""
    rng = np.random.default_rng(70 + m)
    rdtype = real_dtype_of(dtype)
    x = rng.standard_normal((N, N))
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal((N, N))
    u = torch.from_numpy(x).to(dtype)
    dx = 2 * LX / (N - 1)
    lap = tops.laplacian_2d((N, N), dx, dx, dtype=rdtype, device="cpu")
    op = lambda v: lap(v)          # no kernel descriptor: the generic path
    specs = ((1j * DT if dtype.is_complex else DT,
              "exp" if dtype.is_complex else "cos_sqrt"),
             (DT, "sinc"))
    got = tk.matfunc_apply_multi(op, u, specs, m=m, reorth=reorth)
    want = _old_matfunc_apply_multi(op, u, specs, m, reorth)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    one = _port_mesh((1, 1), AX2)
    slap = tspatial.sharded_laplacian_2d((N, N), dx, dx, one, AX2,
                                         dtype=rdtype)
    sharded = tk.matfunc_apply_multi(slap, [u], specs, m=m, reorth=reorth,
                                     mesh=one)
    assert all(torch.equal(s[0], w) for s, w in zip(sharded, want))
    if rdtype == torch.float64:
        four = _port_mesh((2, 2), AX2)
        slap = tspatial.sharded_laplacian_2d((N, N), dx, dx, four, AX2,
                                             dtype=rdtype)
        outs = tk.matfunc_apply_multi(slap, shards.shard(u, four), specs,
                                      m=m, reorth=reorth, mesh=four)
        for o, w in zip(outs, want):
            np.testing.assert_allclose(shards.gather(o, four).numpy(),
                                       w.numpy(), rtol=0, atol=1e-12)
