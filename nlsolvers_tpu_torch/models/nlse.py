"""NLSE SS2 Strang splitting (port of nlsolvers_tpu/models/nlse.py).

tau = i*dt throughout, as in the reference drivers (nlse_cubic_solver.hpp:
58-59). ss2_step <-> NLSESolver::step (nlse_cubic_solver.hpp:54-74).

The phase kick and the density are plain torch ops in this port. sEWI and
Gautschi are not ported yet (ROADMAP.md queue 1, item 6).
"""

import torch

from nlsolvers_tpu_torch.config import default_krylov_m
from nlsolvers_tpu_torch.ops.krylov import expm_apply

__all__ = ["ss2_step", "ss2_step_planar", "phase_kick_planar"]


def ss2_step(u, lap, rho_fn, dt, m=default_krylov_m, reorth=True):
    """One SS2 Strang step: half nonlinear phase, full linear expm, half
    phase."""
    tau = 1j * dt
    u = torch.exp(0.5 * tau * rho_fn(u)) * u
    u = expm_apply(lap, u, tau, m=m, reorth=reorth)
    return torch.exp(0.5 * tau * rho_fn(u)) * u


def phase_kick_planar(up, rho, theta):
    """up * exp(i*theta*rho) on PLANAR (2, ...) float32 state."""
    th = theta * rho
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([up[0] * c - up[1] * s, up[0] * s + up[1] * c])


def ss2_step_planar(up, desc, rho_fn, dt, m=default_krylov_m):
    """SS2 on PLANAR state (2, R, nx) float32 (R = ny in 2D, nz*ny in 3D):
    the fused-kernel path. `desc` is the operator's kernel descriptor;
    `rho_fn` a planar density."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import matfunc_apply_planar

    up = phase_kick_planar(up, rho_fn(up), 0.5 * dt)
    up = matfunc_apply_planar(up, desc, 1j * dt, "exp", m)
    return phase_kick_planar(up, rho_fn(up), 0.5 * dt)
