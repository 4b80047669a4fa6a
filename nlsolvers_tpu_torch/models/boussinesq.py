"""Boussinesq steppers (port of nlsolvers_tpu/models/boussinesq.py; the
reference's gen-1 bouss_solver.hpp).

    u_tt - Lap u + 3 (u^2)_xx - u_xxxx = 0
    =>  u_tt + L u = g(u),   L = -Lap - d^4/dx^4,   g(u) = -3 (u^2)_xx

Gautschi step (bouss_solver.hpp:48-67):
    u' = 2 cos(dt W) u - u_past + dt^2 sinc^2(dt/2 W) g(F u),  F = dt W
with the filter and the cosine from one Lanczos run of u. Stiff
Stormer-Verlet (bouss_solver.hpp:69-81):
    u' = 2u - u_past + dt^2 (L u + 3 (u^2)_xx)
with whatever L the caller passes, as the reference does. The operator has
no kernel descriptor, so every matrix function takes the generic Krylov
path.

`uxx_1d` is the reference's second x-derivative with its one-sided row ends
(bouss_solver.hpp:17-45): (u[1] - u[0])/dx^2 and (u[-2] - u[-1])/dx^2.
"""

import torch

from nlsolvers_tpu_torch.config import default_krylov_m
from nlsolvers_tpu_torch.ops.krylov import matfunc_apply, matfunc_apply_multi
from nlsolvers_tpu_torch.ops.operators import biharmonic_x, laplacian_2d

__all__ = ["uxx_1d", "boussinesq_omega2", "gautschi_step", "stiff_sv_step"]


def uxx_1d(u, dx):
    """Second derivative along the last axis with one-sided row-end
    closures."""
    inv = 1.0 / (dx * dx)
    interior = (u[..., :-2] - 2.0 * u[..., 1:-1] + u[..., 2:]) * inv
    left = ((u[..., 1] - u[..., 0]) * inv)[..., None]
    right = ((u[..., -2] - u[..., -1]) * inv)[..., None]
    return torch.cat([left, interior, right], dim=-1)


def boussinesq_omega2(shape, dx, dtype=torch.float64, variant="reference",
                      device="cuda"):
    """L = -Lap - d4/dx4 as a matrix-free closure (bouss_solver.hpp:3-15),
    without a kernel descriptor."""
    lap = laplacian_2d(shape, dx, dx, variant=variant, dtype=dtype,
                       device=device)
    bih = biharmonic_x(shape, dx, dtype=dtype, device=device)

    def apply(u):
        return -lap(u) - bih(u)

    return apply


def gautschi_step(u, u_past, omega2, dx, dt, m=default_krylov_m,
                  reorth=True):
    """One Boussinesq Gautschi step; returns (u_new, u)."""
    fu, cu = matfunc_apply_multi(omega2, u,
                                 ((dt, "id_sqrt"), (dt, "cos_sqrt")),
                                 m=m, reorth=reorth)
    g = -3.0 * uxx_1d(fu * fu, dx)
    s2 = matfunc_apply(omega2, g, dt, "sinc2_sqrt_half", m=m, reorth=reorth)
    return 2.0 * cu - u_past + (dt * dt) * s2, u


def stiff_sv_step(u, u_past, L_apply, dx, dt):
    """One stiff SV step; returns (u_new, u) (bouss_solver.hpp:69-81)."""
    accel = L_apply(u) + 3.0 * uxx_1d(u * u, dx)
    return 2.0 * u - u_past + (dt * dt) * accel, u
