"""The port's real-wave family against the JAX package.

* g(u) and V(u) of every kind on seeded float64 inputs: rtol 1e-12;
* gautschi_step and sv_step with every kind, at 64^2 and 16^3, the
  Laplacian and div(c grad u), float64 on the generic Krylov path: rtol
  1e-10; the Gautschi step on +Lap and on -Lap gives the same u;
* -Lap carries Lap's descriptor with the sign flipped, weights shared;
* realwave_problem in float32 on the planar route (the kernels' plain
  versions at P=1) against JAX's float32 problem with its Pallas kernels in
  interpret mode, 2 steps at 128^2 and 16x16x128: rtol 2e-5, atol 2e-6;
* the 3D float32 route's bc3d ghost copy equals the plain copy and leaves
  u_past alone; a JAX state and fields carried across with utils/interop
  take the same next step; run() returns the (u, v) stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import nonlinearities as jnl
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.models import realwave as jrw
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu_torch.models import nonlinearities as tnl
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.models import realwave as trw
from nlsolvers_tpu_torch.ops import boundaries as tbcs
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.utils import interop

torch.set_num_threads(1)

KINDS = jnl.REALWAVE_KINDS
LX, DT, M = 5.0, 1e-2, 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_kinds_match_jax():
    assert tnl.REALWAVE_KINDS == jnl.REALWAVE_KINDS


@pytest.mark.parametrize("kind", KINDS)
def test_g_matches_jax(kind):
    u = np.random.default_rng(1).uniform(-2.0, 2.0, (7, 33))
    got = tnl.realwave_g(kind)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnl.realwave_g(kind)(
        jnp.asarray(u))), rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS + ("stochastic_phi4",))
def test_potential_matches_jax(kind):
    u = np.random.default_rng(2).uniform(-2.0, 2.0, (7, 33))
    got = tnl.realwave_potential(kind)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnl.realwave_potential(kind)(
        jnp.asarray(u))), rtol=1e-12)


def test_code_forms_not_header_forms():
    """KG's force is -m u^3 and double sine-Gordon's g is sin u + 0.6 sin
    2u (the reference's code, not its header comments)."""
    u = torch.tensor([0.3, -1.1], dtype=torch.float64)
    assert torch.equal(tnl.realwave_g("klein_gordon")(u), u ** 3)
    torch.testing.assert_close(tnl.realwave_g("double_sine_gordon")(u),
                               torch.sin(u) + 0.6 * torch.sin(2 * u),
                               rtol=0, atol=0)


def _grid(shape):
    return 2.0 * LX / (shape[-1] - 1)


def _c(shape, seed=3):
    return 1.0 + 0.4 * np.random.default_rng(seed).random(shape)


def _operators(shape, aniso, dtype=np.float64):
    """(JAX lap, port lap) on the same grid: the Laplacian or div(c grad u)."""
    dx = _grid(shape)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    if aniso:
        c = _c(shape).astype(dtype)
        if len(shape) == 2:
            return (jops.anisotropic_laplacian_2d(c, dx, dx),
                    tops.anisotropic_laplacian_2d(c, dx, dx, device="cpu"))
        return (jops.anisotropic_laplacian_3d(c, dx),
                tops.anisotropic_laplacian_3d(c, dx, device="cpu"))
    if len(shape) == 2:
        return (jops.laplacian_2d(shape, dx, dx, dtype=dtype),
                tops.laplacian_2d(shape, dx, dx, dtype=tdtype, device="cpu"))
    return (jops.laplacian_3d(shape, dx, dtype=dtype),
            tops.laplacian_3d(shape, dx, dtype=tdtype, device="cpu"))


def _fields(shape, seed=4):
    rng = np.random.default_rng(seed)
    u = 0.5 * rng.standard_normal(shape)
    u_past = u - DT * 0.3 * rng.standard_normal(shape)
    m = 0.5 + rng.random(shape)
    return u, u_past, m


@pytest.mark.parametrize("shape", [(64, 64), (16, 16, 16)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "cx"])
@pytest.mark.parametrize("kind", KINDS)
def test_steps_match_jax_f64(kind, aniso, shape):
    """gautschi_step and sv_step on the generic float64 path: the same
    filter, the same -Lap for Gautschi, +Lap for SV."""
    jlap, tlap = _operators(shape, aniso)
    u, u_past, m = _fields(shape)
    filt = "mod_cosine" if kind == "sine_gordon" else "id_sqrt"
    jg, tg = jnl.realwave_g(kind), tnl.realwave_g(kind)
    T = torch.from_numpy
    want = jrw.gautschi_step(jnp.asarray(u), jnp.asarray(u_past),
                             lambda x: -jlap(x), jnp.asarray(m), jg, DT,
                             m=M, filter_func=filt)[0]
    got = trw.gautschi_step(T(u), T(u_past), tproblems._negated(tlap), T(m),
                            tg, DT, m=M, filter_func=filt)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    want = jrw.sv_step(jnp.asarray(u), jnp.asarray(u_past), jlap,
                       jnp.asarray(m), jg, DT)[0]
    got = trw.sv_step(T(u), T(u_past), tlap, T(m), tg, DT)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("filt", ["mod_cosine", "id_sqrt"])
def test_gautschi_sign_insensitive(filt):
    """The reference passes +Lap (sg_single_driver.cpp:93) or -Lap
    (kg_driver.cpp:92); the |lambda| matrix functions make both give the
    same u."""
    _, tlap = _operators((64, 64), False)
    u, u_past, m = (torch.from_numpy(a) for a in _fields((64, 64)))
    plus = trw.gautschi_step(u, u_past, tlap, m, torch.sin, DT, m=M,
                             filter_func=filt)[0]
    minus = trw.gautschi_step(u, u_past, tproblems._negated(tlap), m,
                              torch.sin, DT, m=M, filter_func=filt)[0]
    np.testing.assert_allclose(plus.numpy(), minus.numpy(), atol=1e-10)


@pytest.mark.parametrize("shape", [(16, 20), (6, 7, 9)], ids=["2d", "3d"])
@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "cx"])
def test_negated_descriptor_shares_weights(shape, aniso):
    _, lap = _operators(shape, aniso, np.float32)
    om = tproblems._negated(lap)
    base = lap.kernel_desc
    assert om.kernel_desc["sign"] == -base["sign"] == -1.0
    assert set(om.kernel_desc) == set(base)
    for k, v in base.items():
        if isinstance(v, torch.Tensor):
            assert om.kernel_desc[k] is v
        elif k != "sign":
            assert om.kernel_desc[k] == v
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    assert torch.equal(om(u), -lap(u))


def _ic(shape, seed=6):
    """Noise of tests/test_pallas.py's real-wave case (amplitude 0.1), and a
    velocity."""
    rng = np.random.default_rng(seed)
    u0 = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v0 = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return u0, v0


F32_CASES = [("sine_gordon", (128, 128), False),
             ("klein_gordon", (128, 128), True),
             ("double_sine_gordon", (16, 16, 128), False),
             ("phi4", (16, 16, 128), True)]


def _jax_f32_run(kind, shape, aniso, steps=2):
    """JAX's float32 Gautschi problem with the Pallas kernels in interpret
    mode: meta and the states after 0..steps steps, as numpy."""
    u0, v0 = _ic(shape)
    c = _c(shape).astype(np.float32) if aniso else None
    m = (0.5 + np.random.default_rng(7).random(shape)).astype(np.float32)
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        prob = jproblems.realwave_problem(kind, shape, LX, DT, m_field=m,
                                          c_field=c, krylov_m=M,
                                          dtype=jnp.float32)
        step = jax.jit(prob.step)
        s = prob.init(u0, v0)
        states = [s]
        for i in range(steps):
            s = step(s, i + 1)
            states.append(s)
        return (prob.meta, m, c,
                [tuple(np.asarray(x) for x in st) for st in states])
    finally:
        jconfig.pallas_mode = old


@pytest.mark.parametrize("kind,shape,aniso", F32_CASES)
def test_f32_planar_problem_matches_jax_interpret(kind, shape, aniso):
    meta, m, c, states = _jax_f32_run(kind, shape, aniso)
    args, kwargs = interop.realwave_args_from_meta(meta, m_field=m,
                                                   c_field=c)
    assert args == (kind, shape, LX, DT)
    prob = tproblems.realwave_problem(*args, dtype=torch.float32,
                                      device="cpu", **kwargs)
    assert prob.meta["filter"] == meta["filter"]
    u0, v0 = _ic(shape)
    s = prob.init(u0, v0)
    for k, (a, b) in enumerate(zip(s, states[0])):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    for i in (1, 2):
        s = prob.step(s, i)
    for a, b in zip(s, states[2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-6)
    # and no further from the float64 run than JAX's float32 run is
    kw64 = dict(kwargs, c_field=None if c is None else c.astype(np.float64))
    ref = tproblems.realwave_problem(*args, dtype=torch.float64,
                                     device="cpu", **kw64)
    r = ref.init(u0, v0)
    for i in (1, 2):
        r = ref.step(r, i)
    r = r[0].numpy()
    err_port = np.abs(s[0].numpy() - r).max()
    err_jax = np.abs(states[2][0] - r).max()
    assert err_port <= 2.0 * err_jax, (err_port, err_jax)
    # JAX's state after one step, carried across, takes the same next step
    s1 = interop.realwave_state_from_numpy(states[1], shape, "cpu")
    got = prob.step(s1, 2)
    np.testing.assert_allclose(got[0].numpy(), states[2][0], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(got[1].numpy(), states[1][0])


def test_interop_rejects_mismatches():
    meta = dict(equation="sine_gordon", integrator="gautschi",
                shape=(8, 9), Lx=1.0, dx=0.25, dt=0.1, krylov_m=5, dim=2,
                filter="id_sqrt")
    with pytest.raises(ValueError):
        interop.realwave_args_from_meta(meta)
    meta["filter"] = "mod_cosine"
    with pytest.raises(ValueError):
        interop.realwave_args_from_meta(meta, m_field=np.ones((9, 8)))
    with pytest.raises(ValueError):
        interop.realwave_state_from_numpy((np.ones((8, 9)),), (8, 9), "cpu")
    with pytest.raises(ValueError):
        interop.realwave_state_from_numpy(
            (np.ones((8, 9)), np.ones((8, 9), complex)), (8, 9), "cpu")


@pytest.mark.parametrize("integrator", ["gautschi", "sv"])
def test_3d_f32_ghost_copy_is_the_plain_copy(integrator):
    """The 3D float32 route ends its step with the bc3d ghost copy (its
    plain version here) in place on the fresh u: the same bits as the
    step's u_new followed by the plain copy, and u_past untouched."""
    shape = (6, 7, 9)
    u0, v0 = _ic(shape)
    prob = tproblems.realwave_problem("sine_gordon", shape, LX, DT,
                                      integrator=integrator, krylov_m=M,
                                      dtype=torch.float32, device="cpu")
    s = prob.init(u0, v0)
    keep = tuple(x.clone() for x in s)
    got = prob.step(s, 1)
    assert all(torch.equal(a, b) for a, b in zip(s, keep))
    assert got[1] is s[0]
    no_bc = tproblems.realwave_problem("sine_gordon", shape, LX, DT,
                                       integrator=integrator, krylov_m=M,
                                       dtype=torch.float32, device="cpu",
                                       apply_bc=False)
    want = tbcs.neumann_no_velocity_3d(no_bc.step(s, 1)[0])
    assert torch.equal(got[0], want)


def test_run_returns_u_and_v_stacks():
    shape = (12, 16)
    u0, v0 = _ic(shape)
    prob = tproblems.realwave_problem("phi4", shape, LX, DT,
                                      integrator="sv", dtype=torch.float64,
                                      device="cpu")
    u, v = tproblems.run(prob, prob.init(u0, v0), 4, 3)
    assert u.shape == v.shape == (4,) + shape
    np.testing.assert_array_equal(u[0].numpy(), u0.astype(np.float64))
    np.testing.assert_allclose(v[0].numpy(), v0, rtol=1e-6, atol=1e-12)
    s = prob.init(u0, v0)
    for i in range(1, 10):
        s = prob.step(s, i)
    np.testing.assert_array_equal(u[3].numpy(), s[0].numpy())
    np.testing.assert_array_equal(v[3].numpy(),
                                  ((s[0] - s[1]) / DT).numpy())


def test_realwave_problem_rejects_unknown_names():
    with pytest.raises(ValueError):
        tproblems.realwave_problem("sine", (8, 8), LX, DT, device="cpu")
    with pytest.raises(ValueError):
        tproblems.realwave_problem("phi4", (8, 8), LX, DT, integrator="rk4",
                                   device="cpu")


@pytest.mark.parametrize("entry", ["realwave_problem",
                                   "stochastic_phi4_problem",
                                   "boussinesq_problem", "biharmonic_x"])
def test_default_device_is_the_card(entry):
    """Called without `device`, an entry point builds on "cuda". Here,
    without a card, it raises torch's error instead of running on the CPU."""
    calls = {
        "realwave_problem": lambda: tproblems.realwave_problem(
            "sine_gordon", (6, 6), LX, DT),
        "stochastic_phi4_problem": lambda: tproblems.stochastic_phi4_problem(
            (6, 6), LX, DT),
        "boussinesq_problem": lambda: tproblems.boussinesq_problem(
            (6, 6), LX, DT),
        "biharmonic_x": lambda: tops.biharmonic_x((6, 6), 0.1),
    }
    if torch.cuda.is_available():
        made = calls[entry]()
        if entry != "biharmonic_x":
            assert made.meta["device"] == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()
