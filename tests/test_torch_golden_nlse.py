"""The port's NLSE integrators against the reference's own trajectories.

golden/data/*.npz were written by the reference's C++ host drivers; each
configuration is replayed with the port's steppers in complex128 on the CPU,
as tests/test_golden.py replays them with the JAX package's, at its gates:
rel-L2 < 1e-5 per stored float32 snapshot and < 1e-7 on the float64 final
snapshot (1e-6 for the 3D Gautschi case, 48 steps of 3 matrix functions).

* the Gautschi comparison family (nlse_*_gautschi_2d): SS2 bootstrap and
  the "cubic" convention for cubic; 10 phi1 substeps and the "plus"
  convention for cubic-quintic and saturable;
* the host-quirk SS2 drivers (nlse_cubic_quintic_2d, nlse_saturating_2d):
  the second half-step reuses the pre-step density, and the saturable one
  divides by (1 + kappa u), the port's host_compat density;
* the 3D Gautschi driver with its c(x) field (nlse_cubic_gautschi_3d).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nlsolvers_tpu_torch.models import nlse as nlse_mod
from nlsolvers_tpu_torch.models.nonlinearities import nlse_density
from nlsolvers_tpu_torch.models.problems import Problem, run
from nlsolvers_tpu_torch.ops import boundaries as bc
from nlsolvers_tpu_torch.ops import operators as ops
from nlsolvers_tpu_torch.ops.krylov import expm_apply

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "golden" / "data"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(traj, d, tol_last=1e-7):
    traj = traj.numpy()
    assert traj.shape == d["traj"].shape
    for k in range(traj.shape[0]):
        assert _rel(traj[k], d["traj"][k]) < 1e-5, k
    assert _rel(traj[-1], d["traj_f64_last"]) < tol_last


def _setup(case):
    d = np.load(DATA / f"{case}.npz")
    shape = d["u0"].shape
    dx = 2.0 * float(d["Lx"]) / (shape[-1] - 1)
    dt = float(d["T"]) / int(d["nt"])
    m = torch.from_numpy(np.asarray(d["m"], np.float64))
    return d, shape, dx, dt, int(d["krylov_m"]), m


def _replay(d, prob):
    nt, snaps = int(d["nt"]), int(d["num_snapshots"])
    return run(prob, prob.init(d["u0"]), snaps, nt // snaps)


def _two_step_problem(bootstrap, gautschi):
    """Driver iteration 1 is the bootstrap (u_prev stays u0), then the
    two-step scheme; the state is (u, u_prev), the snapshot u."""
    def step(state, i):
        return bootstrap(state) if i == 1 else gautschi(state)

    def init(u0):
        u = torch.from_numpy(np.asarray(u0, np.complex128))
        return (u, u)

    return Problem(step, init, lambda s: s[0], {})


@pytest.mark.parametrize("case,kind", [
    ("nlse_cubic_gautschi_2d", "cubic"),
    ("nlse_cubic_quintic_gautschi_2d", "cubic_quintic"),
    ("nlse_saturating_gautschi_2d", "saturable"),
])
def test_golden_nlse_gautschi_2d(case, kind):
    d, shape, dx, dt, km, m = _setup(case)
    lap = ops.laplacian_2d(shape, dx, dx, dtype=torch.float64, device="cpu")
    if kind == "cubic_quintic":
        params = dict(sigma1=float(d["sigma1"]), sigma2=float(d["sigma2"]))
    elif kind == "saturable":       # the Gautschi solver's |u|^2 form
        params = dict(kappa=float(d["kappa"]))
    else:
        params = {}
    rho = nlse_density(kind, m, **params)
    convention = "cubic" if kind == "cubic" else "plus"
    bcf = bc.neumann_no_velocity_2d

    def bootstrap(state):
        u, u_prev = state
        if kind == "cubic":
            un = bcf(nlse_mod.ss2_step(u, lap, rho, dt, m=km))
        else:
            un = nlse_mod.gautschi_phi1_bootstrap(u, lap, rho, dt, bc_fn=bcf,
                                                  pre_steps=10, m=km)
        return un, u_prev

    def gautschi(state):
        un, up = nlse_mod.gautschi_step(*state, lap, rho, dt, m=km,
                                        convention=convention)
        return bcf(un), up

    _check(_replay(d, _two_step_problem(bootstrap, gautschi)), d)


@pytest.mark.parametrize("case,kind", [("nlse_cubic_quintic_2d", "quintic"),
                                       ("nlse_saturating_2d", "saturating")])
def test_golden_nlse_host_quirk_ss2(case, kind):
    """nlse_cubic_quintic_solver.hpp:22-27 and nlse_saturating_solver.hpp:
    16-31: the second phase kick reuses the pre-step |u|^2."""
    d, shape, dx, dt, km, m = _setup(case)
    lap = ops.laplacian_2d(shape, dx, dx, dtype=torch.float64, device="cpu")
    tau = 1j * dt

    if kind == "quintic":
        s1, s2 = float(d["sigma1"]), float(d["sigma2"])

        def step(u, i):
            del i
            a = u.real ** 2 + u.imag ** 2
            half = torch.exp(0.5 * tau * (m * (s1 * a + s2 * a * a)))
            buf = expm_apply(lap, half * u, tau, m=km)
            return bc.neumann_no_velocity_2d(half * buf)
    else:
        kappa = float(d["kappa"])
        rho_host = nlse_density("saturable", m, kappa=kappa,
                                host_compat=True)

        def step(u, i):
            del i
            a = u.real ** 2 + u.imag ** 2
            buf = expm_apply(lap, torch.exp(0.5 * tau * rho_host(u)) * u,
                             tau, m=km)
            rho2 = m * a / (1.0 + kappa * buf)      # stale numerator a
            return bc.neumann_no_velocity_2d(torch.exp(0.5 * tau * rho2)
                                             * buf)

    init = lambda u0: torch.from_numpy(np.asarray(u0, np.complex128))
    _check(_replay(d, Problem(step, init, lambda s: s, {})), d)


def test_golden_nlse_cubic_gautschi_3d():
    """nlse_cubic_gautschi_driver_3d.cpp: one SS2 bootstrap step on the 3D
    anisotropic operator (:126-131), then the "cubic" Gautschi two-step
    (:138-141), the ghost copy after every step."""
    d, shape, dx, dt, km, m = _setup("nlse_cubic_gautschi_3d")
    lap = ops.anisotropic_laplacian_3d(np.asarray(d["c"], np.float64), dx,
                                       device="cpu")
    rho = nlse_density("cubic", m)
    bcf = bc.neumann_no_velocity_3d

    def bootstrap(state):
        u, u_prev = state
        return bcf(nlse_mod.ss2_step(u, lap, rho, dt, m=km)), u_prev

    def gautschi(state):
        un, up = nlse_mod.gautschi_step(*state, lap, rho, dt, m=km,
                                        convention="cubic")
        return bcf(un), up

    _check(_replay(d, _two_step_problem(bootstrap, gautschi)), d,
           tol_last=1e-6)
