"""The port's 3D cubic SS2 slice end to end, against the JAX package and the
reference's golden trajectories.

* planar complex64 problem (7-point Laplacian, and div(c grad u) with a c(x)
  field) vs JAX's planar problem with the Pallas kernels in interpret mode,
  after 3 steps: rel-L2 <= 1e-5 (same algorithm in float32; only summation
  order differs);
* a JAX state and c(x) carried across with utils/interop take the same next
  step: rel-L2 <= 1e-5;
* complex128 vs golden/data/nlse_cubic_3d(_long).npz at the gates of
  tests/test_golden.py: 1e-5 per float32 snapshot, and 1e-7 (48 steps) /
  1e-6 (600 steps) on the float64 final snapshot;
* without `device`, the entry points target the card: on a machine without
  one they raise instead of running on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import bc3d as tb
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.utils import interop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHAPE, M, LX, DT, STEPS = (8, 16, 128), 8, 5.0, 1e-3, 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u0():
    z, y, x = (np.linspace(-LX, LX, n, dtype=np.float32) for n in SHAPE)
    r2 = z[:, None, None] ** 2 + y[None, :, None] ** 2 + x[None, None, :] ** 2
    return (np.exp(-r2 / 4) * np.exp(0.4j * x)).astype(np.complex64)


def _c(aniso):
    if not aniso:
        return None
    return (1.0 + 0.4 * np.random.default_rng(0).random(SHAPE)).astype(
        np.float32)


def _kw(aniso):
    return dict(m_field=np.ones(SHAPE, np.float32), c_field=_c(aniso),
                krylov_m=M)


def _jax_states(aniso):
    """JAX planar cubic SS2 problem with the Pallas kernels in interpret
    mode: its meta and the states after 0..STEPS steps, as numpy."""
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        prob = jproblems.nlse_problem("cubic", SHAPE, LX, DT,
                                      dtype=jnp.complex64, **_kw(aniso))
        step = jax.jit(prob.step)
        s = prob.init(_u0())
        states = [s]
        for i in range(STEPS):
            s = step(s, i + 1)
            states.append(s)
        obs = [np.asarray(prob.observe(x)) for x in states]
        return prob.meta, [np.asarray(x) for x in states], obs
    finally:
        jconfig.pallas_mode = old


@pytest.fixture(scope="module", params=[False, True], ids=["iso", "cfield"])
def jax_run(request):
    return request.param, _jax_states(request.param)


def test_planar_problem_matches_jax_interpret(jax_run):
    aniso, (meta, _, obs) = jax_run
    assert meta["planar_state"]
    prob = tproblems.nlse_problem("cubic", SHAPE, LX, DT,
                                  dtype=torch.complex64, device="cpu",
                                  **_kw(aniso))
    assert prob.meta["planar_state"] and prob.meta["dim"] == 3
    assert prob.meta["krylov_m"] == M
    s = prob.init(_u0())
    R, nx = SHAPE[0] * SHAPE[1], SHAPE[2]
    assert s.dtype == torch.float32 and tuple(s.shape) == (2, R, nx)
    counters = (t3.pass1_3d, t3.pass2, tb.neumann_bc_planar_3d)
    before = [f.launches for f in counters]
    for i in range(1, STEPS + 1):
        s = prob.step(s, i)
    assert [f.launches for f in counters] == before      # plain on the CPU
    got = prob.observe(s)
    assert got.dtype == torch.complex64 and tuple(got.shape) == SHAPE
    assert _rel(got.numpy(), obs[-1]) <= 1e-5


def test_jax_state_handed_across_steps_alike(jax_run):
    """A JAX planar state after k steps and the c(x) field, carried across
    with utils/interop, take the same next step in the port."""
    aniso, (meta, states, obs) = jax_run
    args, kwargs = interop.nlse_args_from_meta(meta, c_field=_c(aniso))
    assert args[1] == SHAPE and ("c_field" in kwargs) == aniso
    m_field = interop.field_from_numpy(np.ones(SHAPE, np.float32), "cpu")
    prob = tproblems.nlse_problem(*args, m_field=m_field,
                                  dtype=torch.complex64, device="cpu",
                                  **kwargs)
    k = STEPS - 1
    s = interop.state_from_numpy(states[k], SHAPE, "cpu")
    assert tuple(s.shape) == (2, SHAPE[0] * SHAPE[1], SHAPE[2])
    got = prob.observe(prob.step(prob.init(s), k + 1))
    assert _rel(got.numpy(), obs[k + 1]) <= 1e-5
    # the complex snapshot goes through init to the same planar state
    sc = interop.state_from_numpy(obs[k], SHAPE, "cpu")
    assert torch.equal(prob.init(sc), s)


def test_planar_sewi_matches_jax_interpret():
    """3D sEWI on the planar path (the SS2 bootstrap at step 1, then the
    two-step scheme through pass1_3d, pass2 and combine), krylov_m=6,
    against JAX's planar problem in interpret mode after 3 steps."""
    kw = dict(_kw(False), krylov_m=6, integrator="sewi")
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        pj = jproblems.nlse_problem("cubic", SHAPE, LX, DT,
                                    dtype=jnp.complex64, **kw)
        step = jax.jit(pj.step)
        s = pj.init(_u0())
        for i in range(1, STEPS + 1):
            s = step(s, i)
        want = np.asarray(pj.observe(s))
    finally:
        jconfig.pallas_mode = old
    assert pj.meta["planar_state"]
    prob = tproblems.nlse_problem("cubic", SHAPE, LX, DT,
                                  dtype=torch.complex64, device="cpu", **kw)
    assert prob.meta["planar_state"] and prob.meta["dim"] == 3
    s = prob.init(_u0())
    for i in range(1, STEPS + 1):
        s = prob.step(s, i)
    assert isinstance(s, tuple)
    assert _rel(prob.observe(s).numpy(), want) <= 1e-5


@pytest.mark.parametrize("case,tol_last", [("nlse_cubic_3d", 1e-7),
                                           ("nlse_cubic_3d_long", 1e-6)])
def test_golden_nlse_cubic_3d_anisotropic(case, tol_last):
    """nlse_cubic_driver_3d with its c(x) field, 40^3, complex128."""
    d = np.load(ROOT / "golden" / "data" / f"{case}.npz")
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    prob = tproblems.nlse_problem(
        "cubic", d["u0"].shape, float(d["Lx"]), float(d["T"]) / nt,
        m_field=d["m"], c_field=d["c"], krylov_m=int(d["krylov_m"]),
        dtype=torch.complex128, device="cpu")
    assert not prob.meta["planar_state"]
    traj = tproblems.run(prob, prob.init(d["u0"]), snaps, nt // snaps).numpy()
    assert traj.shape == d["traj"].shape
    for k in range(snaps):
        assert _rel(traj[k], d["traj"][k]) < 1e-5, k
    assert _rel(traj[-1], d["traj_f64_last"]) < tol_last


@pytest.mark.parametrize("entry", ["nlse_problem", "laplacian_2d",
                                   "laplacian_3d", "anisotropic_laplacian_3d"])
def test_default_device_is_the_card(entry):
    """Called without `device`, an entry point builds on "cuda". Here,
    without a card, it raises torch's error instead of running on the CPU."""
    calls = {
        "nlse_problem": lambda: tproblems.nlse_problem(
            "cubic", (6, 6, 6), LX, DT, m_field=np.ones((6, 6, 6))),
        "laplacian_2d": lambda: tops.laplacian_2d((6, 6), 0.1, 0.1),
        "laplacian_3d": lambda: tops.laplacian_3d((6, 6, 6), 0.1),
        "anisotropic_laplacian_3d": lambda: tops.anisotropic_laplacian_3d(
            np.ones((6, 6, 6)), 0.1),
    }
    if torch.cuda.is_available():
        made = calls[entry]()
        if entry == "nlse_problem":
            assert made.meta["device"] == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()
