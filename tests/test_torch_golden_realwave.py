"""The port's real-wave and Boussinesq integrators against the reference's
own trajectories.

golden/data/*.npz were written by the reference's C++ host drivers; each
configuration is replayed with the port in float64 on the CPU, as
tests/test_golden.py replays them with the JAX package's, at its gates:
rel-L2 < 1e-5 per stored float32 snapshot of u and < 1e-7 on the float64
final one (1e-6 for the 3D Gautschi case); the velocity (u - u_past)/dt,
which amplifies rounding by 1/dt, at 5e-5 / 1e-5 (Boussinesq, dt = 1e-3:
2e-4 / 1e-4).

* the nine 2D WAVE_CASES through realwave_problem (Klein-Gordon,
  sine-Gordon single, double and hyperbolic, phi-4; Gautschi and SV);
* the 3D c(x) Klein-Gordon drivers, SV and Gautschi. The Gautschi case is
  held at every gate but the velocity's float64 final snapshot: there a
  relative perturbation of 1e-15 in u0 moves the JAX package's own error
  between 8.8e-6 and 1.7e-5 (six draws; its unperturbed run reads 4.4e-6),
  the port reads 1.07e-5. The gate tests rounding luck there, so that
  number is printed, not asserted; what is asserted instead is that each
  of the run's steps, taken by JAX's step and by the port's from the same
  float64 state, agrees to float64 rounding
  (test_kg_gautschi_3d_steps_match_jax_at_f64_rounding);
* the Boussinesq drivers (no BC): Gautschi through boussinesq_problem, the
  stiff SV step given L = Lap + d4/dx4 as tests/test_golden.py gives it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.models import boussinesq as bq
from nlsolvers_tpu_torch.models.problems import (Problem, boussinesq_problem,
                                                 realwave_problem, run)

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "golden" / "data"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _check(mine, d, key="traj", tol_traj=1e-5, tol_last=1e-7):
    """Each float32 snapshot within tol_traj, the float64 final one within
    tol_last (None: printed only)."""
    mine = np.asarray(mine)
    gold = d[key]
    assert mine.shape == gold.shape
    for k in range(gold.shape[0]):
        err = _rel(mine[k], gold[k])
        assert err < tol_traj, f"snapshot {k}: rel L2 {err:.3e} vs {key}"
    err = _rel(mine[-1], d[f"{key}_f64_last"])
    print(f"{key}: final f64 rel L2 {err:.3e}")
    assert tol_last is None or err < tol_last, f"final f64 rel L2 {err:.3e}"


def _replay(d, kind, **kw):
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    prob = realwave_problem(kind, d["u0"].shape, float(d["Lx"]),
                            float(d["T"]) / nt, m_field=d["m"],
                            krylov_m=int(d["krylov_m"]),
                            dtype=torch.float64, device="cpu", **kw)
    return run(prob, prob.init(d["u0"], d["v0"]), snaps, nt // snaps)


WAVE_CASES = [
    ("kg_gautschi_2d", "klein_gordon", "gautschi"),
    ("kg_sv_2d", "klein_gordon", "sv"),
    ("sg_gautschi_2d", "sine_gordon", "gautschi"),
    ("sg_sv_2d", "sine_gordon", "sv"),
    ("phi4_gautschi_2d", "phi4", "gautschi"),
    ("sg_double_gautschi_2d", "double_sine_gordon", "gautschi"),
    ("sg_hyperbolic_gautschi_2d", "hyperbolic_sine_gordon", "gautschi"),
    ("sg_double_sv_2d", "double_sine_gordon", "sv"),
    ("sg_hyperbolic_sv_2d", "hyperbolic_sine_gordon", "sv"),
]


@pytest.mark.parametrize("case,kind,integ", WAVE_CASES)
def test_golden_realwave_2d(case, kind, integ):
    d = np.load(DATA / f"{case}.npz")
    u, v = _replay(d, kind, integrator=integ)
    _check(u, d, "traj")
    _check(v, d, "vel", tol_traj=5e-5, tol_last=1e-5)


@pytest.mark.parametrize("case,integ,tol_last,tol_vel_last",
                         [("kg_sv_3d", "sv", 1e-7, 1e-5),
                          ("kg_gautschi_3d", "gautschi", 1e-6, None)])
def test_golden_kg_3d_anisotropic(case, integ, tol_last, tol_vel_last):
    """kg_sv_driver_3d / kg_driver_3d with their c(x) field; 48 Gautschi
    steps of 3D c(x) accumulate more rounding, hence 1e-6 on the final u
    (and see the module docstring for its final velocity)."""
    d = np.load(DATA / f"{case}.npz")
    u, v = _replay(d, "klein_gordon", integrator=integ, c_field=d["c"])
    _check(u, d, "traj", tol_last=tol_last)
    _check(v, d, "vel", tol_traj=5e-5, tol_last=tol_vel_last)


# per-step bound: the rel-L2 difference of u_new between JAX's step and the
# port's from one float64 state, ~450 float64 epsilons; both sides sum the
# same terms in orders that XLA and torch pick, nothing more
STEP_F64_TOL = 1e-13


def test_kg_gautschi_3d_steps_match_jax_at_f64_rounding():
    """Every step of the kg_gautschi_3d golden run (36 steps: snapshots 0-3
    every 12 steps) taken twice from JAX's float64 state, by JAX's jitted
    step and by the port's: u_new within STEP_F64_TOL in rel-L2. u_past is
    the input u on both sides, so the velocity (u_new - u_past)/dt differs
    by that same difference over dt. The free-running final velocities of
    both against the golden file are printed: the gate of 1e-5 that JAX's
    run passes at 4.4e-6 and the port's misses at 1.07e-5 reads how the
    rounding of ~36 steps falls, not a step that departs from JAX's."""
    d = np.load(DATA / "kg_gautschi_3d.npz")
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    dt = float(d["T"]) / nt
    shape = d["u0"].shape
    common = dict(m_field=d["m"], c_field=d["c"], integrator="gautschi",
                  krylov_m=int(d["krylov_m"]))
    pj = jproblems.realwave_problem("klein_gordon", shape, float(d["Lx"]),
                                    dt, dtype=jnp.float64, **common)
    pt = realwave_problem("klein_gordon", shape, float(d["Lx"]), dt,
                          dtype=torch.float64, device="cpu", **common)
    jstep = jax.jit(pj.step)
    sj = pj.init(d["u0"], d["v0"])
    st = pt.init(d["u0"], d["v0"])
    worst = 0.0
    for i in range(1, (snaps - 1) * (nt // snaps) + 1):
        u, u_past = (np.array(x) for x in sj)
        sj = jstep(sj, i)
        ju = np.asarray(sj[0])
        tu, tu_past = pt.step((torch.from_numpy(u), torch.from_numpy(u_past)),
                              i)
        assert np.array_equal(tu_past.numpy(), u)
        err = _rel(tu.numpy(), ju)
        worst = max(worst, err)
        assert err < STEP_F64_TOL, f"step {i}: rel L2 {err:.3e}"
        st = pt.step(st, i)
    print(f"kg_gautschi_3d: worst per-step rel L2 {worst:.3e}")
    for who, (u, u_past) in (("jax", (np.asarray(x) for x in sj)),
                             ("port", (x.numpy() for x in st))):
        err = _rel((u - u_past) / dt, d["vel_f64_last"])
        print(f"kg_gautschi_3d {who}: final f64 velocity rel L2 {err:.3e}")


@pytest.mark.parametrize("mode", ["gautschi", "stiff"])
def test_golden_boussinesq(mode):
    """bouss_driver (bouss_solver.hpp:3-81): no BC, u_past = u0 - dt v0,
    v = (u - u_past)/dt."""
    d = np.load(DATA / f"bouss_{mode}_2d.npz")
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    dt = float(d["T"]) / nt
    shape = d["u0"].shape
    u0 = torch.from_numpy(np.asarray(d["u0"], np.float64))
    v0 = torch.from_numpy(np.asarray(d["v0"], np.float64))
    if mode == "gautschi":
        prob = boussinesq_problem(shape, float(d["Lx"]), dt,
                                  krylov_m=int(d["krylov_m"]),
                                  dtype=torch.float64, apply_bc=False,
                                  device="cpu")
    else:
        dx = 2.0 * float(d["Lx"]) / (shape[-1] - 1)
        omega2 = bq.boussinesq_omega2(shape, dx, dtype=torch.float64,
                                      device="cpu")
        L_apply = lambda u: -omega2(u)          # Lap + d4/dx4

        def step(state, i):
            del i
            return bq.stiff_sv_step(*state, L_apply, dx, dt)

        prob = Problem(step, None, lambda s: (s[0], (s[0] - s[1]) / dt), {})
    u, v = run(prob, (u0, u0 - dt * v0), snaps, nt // snaps)
    u, v = u.numpy(), v.numpy()
    u[0], v[0] = u0.numpy(), v0.numpy()
    _check(u, d, "traj")
    # velocity = (u - u_past)/dt amplifies rounding by 1/dt = 1000x
    _check(v, d, "vel", tol_traj=2e-4, tol_last=1e-4)
