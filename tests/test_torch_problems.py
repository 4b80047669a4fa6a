"""The port's 2D cubic SS2 slice end to end, against the JAX package and the
reference's golden trajectories.

* planar complex64 problem vs JAX's planar problem with the Pallas kernels in
  interpret mode: rel-L2 <= 1e-5 (same algorithm in float32; only summation
  order differs);
* vs JAX's complex problem with the kernels off: the gate of
  tests/test_pallas.py (rtol 2e-4, atol 2e-5), since the complex path's
  Lanczos rounds differently in float32;
* complex128 vs golden/data at the gates of tests/test_golden.py: 1e-5 per
  float32 snapshot and 1e-7 on the float64 final snapshot.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import evolve as jevolve
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.models import evolve as tevolve
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.utils import interop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N, M, LX, DT, STEPS = 128, 8, 5.0, 1e-3, 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u0(n=N):
    x = np.linspace(-LX, LX, n, dtype=np.float32)
    env = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4)
    return (env * np.exp(0.4j * x[None, :])).astype(np.complex64)


def _kw(n=N):
    return dict(m_field=np.ones((n, n), np.float32), krylov_m=M)


def _jax_states(mode):
    """JAX cubic SS2 problem under pallas_mode `mode`: its meta and the
    states after 0..STEPS steps, as numpy."""
    old = jconfig.pallas_mode
    jconfig.pallas_mode = mode
    try:
        prob = jproblems.nlse_problem("cubic", (N, N), LX, DT,
                                      dtype=jnp.complex64, **_kw())
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


@pytest.fixture(scope="module")
def jax_interpret():
    return _jax_states("interpret")


def _port_problem():
    return tproblems.nlse_problem("cubic", (N, N), LX, DT,
                                  dtype=torch.complex64, device="cpu",
                                  **_kw())


def _port_run(prob, s, first, steps):
    for i in range(first, first + steps):
        s = prob.step(s, i)
    return s


def test_planar_problem_matches_jax_interpret(jax_interpret):
    meta, _, obs = jax_interpret
    assert meta["planar_state"]
    prob = _port_problem()
    assert prob.meta["planar_state"]
    s = prob.init(_u0())
    assert s.dtype == torch.float32 and tuple(s.shape) == (2, N, N)
    got = prob.observe(_port_run(prob, s, 1, STEPS))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), obs[-1]) <= 1e-5


def test_planar_problem_matches_jax_complex_path():
    meta, _, obs = _jax_states("off")
    assert not meta["planar_state"]
    prob = _port_problem()
    got = prob.observe(_port_run(prob, prob.init(_u0()), 1, STEPS))
    np.testing.assert_allclose(got.numpy(), obs[-1], rtol=2e-4, atol=2e-5)


def test_jax_state_handed_across_steps_alike(jax_interpret):
    """A JAX state after k steps, carried across with utils/interop, takes
    the same next step in the port (rel-L2 <= 1e-5)."""
    meta, states, obs = jax_interpret
    args, kwargs = interop.nlse_args_from_meta(meta)
    m_field = interop.field_from_numpy(_kw()["m_field"], "cpu")
    prob = tproblems.nlse_problem(*args, m_field=m_field,
                                  dtype=torch.complex64, device="cpu",
                                  **kwargs)
    k = STEPS - 1
    s = interop.state_from_numpy(states[k], (N, N), "cpu")
    got = prob.observe(prob.step(prob.init(s), k + 1))
    assert _rel(got.numpy(), obs[k + 1]) <= 1e-5
    # a complex state goes through init to the same planar state
    sc = interop.state_from_numpy(obs[k], (N, N), "cpu")
    assert torch.equal(prob.init(sc), s)


def test_evolve_snapshot_cadence_matches_jax():
    """Snapshot 0 is the initial state; step indices count from 1."""
    want = jevolve.evolve(lambda s, i: s + i, jnp.float64(0.0), 4, 3)
    got = tevolve.evolve(lambda s, i: s + i, torch.tensor(0.0,
                                                          dtype=torch.float64),
                         4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [0.0, 6.0, 21.0, 45.0]


def test_run_matches_jax_complex128():
    """run() on the complex path in float64: rel-L2 <= 1e-10 per snapshot."""
    n = 32
    u0 = _u0(n).astype(np.complex128)
    kw = dict(m_field=np.ones((n, n)), krylov_m=10)
    pj = jproblems.nlse_problem("cubic", (n, n), LX, DT, dtype=jnp.complex128,
                                **kw)
    pt = tproblems.nlse_problem("cubic", (n, n), LX, DT,
                                dtype=torch.complex128, device="cpu", **kw)
    assert not pt.meta["planar_state"]
    want = np.asarray(jproblems.run(pj, pj.init(u0), 4, 3))
    got = tproblems.run(pt, pt.init(u0), 4, 3).numpy()
    assert got.shape == want.shape == (4, n, n)
    for k in range(4):
        assert _rel(got[k], want[k]) <= 1e-10


@pytest.mark.parametrize("case", ["nlse_cubic_2d", "nlse_cubic_2d_long"])
def test_golden_nlse_cubic_2d(case):
    d = np.load(ROOT / "golden" / "data" / f"{case}.npz")
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    prob = tproblems.nlse_problem(
        "cubic", d["u0"].shape, float(d["Lx"]), float(d["T"]) / nt,
        m_field=d["m"], krylov_m=int(d["krylov_m"]), dtype=torch.complex128,
        device="cpu")
    traj = tproblems.run(prob, prob.init(d["u0"]), snaps, nt // snaps).numpy()
    assert traj.shape == d["traj"].shape
    for k in range(snaps):
        assert _rel(traj[k], d["traj"][k]) < 1e-5, k
    assert _rel(traj[-1], d["traj_f64_last"]) < 1e-7


def test_import_loads_no_jax():
    code = ("import sys, nlsolvers_tpu_torch\n"
            "import nlsolvers_tpu_torch.models.problems\n"
            "import nlsolvers_tpu_torch.models.nlse\n"
            "import nlsolvers_tpu_torch.models.nonlinearities\n"
            "import nlsolvers_tpu_torch.ops.boundaries\n"
            "import nlsolvers_tpu_torch.ops.operators\n"
            "import nlsolvers_tpu_torch.ops.cuda.lanczos2d\n"
            "import nlsolvers_tpu_torch.ops.cuda.lanczos3d\n"
            "import nlsolvers_tpu_torch.ops.cuda.bc3d\n"
            "import nlsolvers_tpu_torch.utils.interop\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'nlsolvers_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("kw,planar", [
    (dict(shape=(8, 8, 8), integrator="sewi"), True),
    (dict(c_field=np.ones((8, 8))), True),
    (dict(integrator="sewi"), True),
    (dict(bc="radiating"), False),
    (dict(variant="separated"), False)],
    ids=["3d", "c_field", "sewi", "radiating", "separated"])
def test_outside_the_slice_raises(kw, planar):
    """The five options that lay outside the first slices (3D sEWI, 2D c(x),
    sEWI, the radiating BC, the separated operator) now build on the CPU
    and take the JAX package's path: planar for the stencil descriptors,
    complex for the radiating BC and the separated operator. Two steps
    (the bootstrap of a two-step integrator and one more) stay finite."""
    kw = dict(kw)
    shape = kw.pop("shape", (8, 8))
    prob = tproblems.nlse_problem("cubic", shape, 5.0, 1e-3, device="cpu",
                                  m_field=np.ones(shape), krylov_m=6, **kw)
    assert prob.meta["planar_state"] == planar
    s = prob.init(np.full(shape, 0.5 + 0.25j, np.complex64))
    for i in (1, 2):
        s = prob.step(s, i)
    u = prob.observe(s)
    assert tuple(u.shape) == shape and u.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(u)).all()
