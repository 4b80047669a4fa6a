"""Problem constructors (port of nlsolvers_tpu/models/problems.py).

Ported for the NLSE stepped by SS2 with bc in {"noflux", "none"}: in 2D with
the 5-point Laplacian, in 3D with the 7-point Laplacian or, given a c(x)
field, the finite-volume div(c grad u). Grid conventions follow the
reference drivers: nx points span [-Lx, Lx] with dx = 2 Lx/(nx-1), and the
no-flux ghost cells are part of the field, copied after every step.

complex64 with an operator the fused kernels support takes the PLANAR path:
the state is (2, R, nx) float32 with R = ny in 2D and nz*ny in 3D, and
`observe` returns the complex field of the grid's shape. Everything else,
complex128 included, takes the complex ss2_step path. The problem lives on
`device`, the card unless the caller asks for the CPU.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from nlsolvers_tpu_torch.config import default_complex_dtype, real_dtype_of
from nlsolvers_tpu_torch.models import nlse as nlse_mod
from nlsolvers_tpu_torch.models.evolve import evolve
from nlsolvers_tpu_torch.models.nonlinearities import (NLSE_KINDS,
                                                       nlse_density,
                                                       nlse_density_planar)
from nlsolvers_tpu_torch.ops import boundaries as bcs
from nlsolvers_tpu_torch.ops import operators as ops

__all__ = ["Problem", "nlse_problem", "run"]


@dataclass(frozen=True)
class Problem:
    """A fully specified evolution problem.

    step:    (state, step_index) -> state
    init:    builds the initial state from a field u0
    observe: state -> snapshot tensor
    meta:    static description (equation, integrator, grid, dt, ...)
    """
    step: Callable
    init: Callable
    observe: Callable
    meta: dict


def run(problem, state0, num_snapshots, snapshot_freq):
    """Evolve and return the observed snapshot stack (index 0 = initial)."""
    return evolve(problem.step, state0, num_snapshots, snapshot_freq,
                  observe=problem.observe)


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _planar_ss2(kind, shape, dt, krylov_m, lap, m_field, sigma1, sigma2,
                kappa, bc, dtype, device):
    """(step, init, observe) on PLANAR (2, R, nx) float32 state when the
    fused kernels support the operator, else None."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import supported_desc

    desc = getattr(lap, "kernel_desc", None)
    if dtype != torch.complex64 or not supported_desc(desc, shape, dtype):
        return None
    nx = shape[-1]
    R = int(np.prod(shape[:-1]))
    m2 = _as_tensor(m_field, device).to(torch.float32).reshape(R, nx)
    rho = nlse_density_planar(kind, m2, sigma1=sigma1, sigma2=sigma2,
                              kappa=kappa)
    if bc != "noflux":
        neum = lambda up: up
    elif len(shape) == 3:
        from nlsolvers_tpu_torch.ops.cuda.bc3d import neumann_bc_planar_3d
        neum = lambda up: neumann_bc_planar_3d(up, shape)
    else:
        neum = bcs.neumann_no_velocity_2d

    def step(up, i):
        del i
        return neum(nlse_mod.ss2_step_planar(up, desc, rho, dt, m=krylov_m))

    def init(u0):
        z = _as_tensor(u0, device)
        if z.is_complex():
            up = torch.stack([z.real, z.imag])
        elif tuple(z.shape) in ((2,) + tuple(shape), (2, R, nx)):
            up = z                               # packed or planar (re, im)
        else:
            up = torch.stack([z, torch.zeros_like(z)])
        return up.to(torch.float32).reshape(2, R, nx).contiguous()

    def observe(up):
        u = up.reshape((2,) + tuple(shape))
        return torch.complex(u[0], u[1])

    return step, init, observe


def nlse_problem(kind, shape, Lx, dt, *, m_field=None, c_field=None,
                 sigma1=1.0, sigma2=-0.1, kappa=1.0, integrator="ss2",
                 krylov_m=None, dtype=default_complex_dtype,
                 variant="reference", apply_bc=True, reorth=True,
                 bc="noflux", device="cuda"):
    """NLSE family: i u_t + div(c grad u) + rho_kind(u) u = 0.

    kind in {"cubic", "cubic_quintic", "saturable"}; `shape` is the full grid
    (ny, nx) or (nz, ny, nx), the domain [-Lx, Lx]^d. c_field (3D only in
    this port) selects the finite-volume operator. m_field defaults to ZERO
    as in the reference drivers (nlse_cubic_driver.cpp:64). Krylov m
    defaults to 20 for 2D cubic, 15 for the other 2D kinds
    (nlse_cubic_driver_2d.cpp:105) and 10 in 3D. `device` is where the
    state, the fields and the operator live: the card by default; asking
    for "cuda" without one raises torch's error, and nothing moves to the
    CPU.
    """
    if kind not in NLSE_KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    if not apply_bc:
        bc = "none"
    dim = len(shape)
    if dim not in (2, 3):
        raise ValueError(f"shape must be (ny, nx) or (nz, ny, nx), got "
                         f"{tuple(shape)}")
    if c_field is not None and dim == 2:
        raise NotImplementedError("the 2D anisotropic c(x) operator is not "
                                  "ported yet (ROADMAP.md queue 1, item 7)")
    if integrator != "ss2":
        raise NotImplementedError(f"integrator {integrator!r} is not ported "
                                  "yet (ROADMAP.md queue 1, item 6)")
    if bc not in ("noflux", "none"):
        raise NotImplementedError(f"bc {bc!r} is not ported yet "
                                  "(ROADMAP.md queue 1, item 2)")
    if variant not in ("reference", "clean"):
        raise NotImplementedError(f"variant {variant!r} is not ported yet "
                                  "(ROADMAP.md queue 1, item 2)")
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    if krylov_m is None:
        krylov_m = ({"cubic": 20, "cubic_quintic": 15, "saturable": 15}[kind]
                    if dim == 2 else 10)
    if m_field is None:
        m_field = np.zeros(shape)
    m_t = _as_tensor(m_field, device).to(rdtype)

    if c_field is not None:
        lap = ops.anisotropic_laplacian_3d(c_field, dx, variant=variant,
                                           device=device)
    elif dim == 3:
        lap = ops.laplacian_3d(shape, dx, variant=variant, dtype=rdtype,
                               device=device)
    else:
        lap = ops.laplacian_2d(shape, dx, dx, variant=variant, dtype=rdtype,
                               device=device)
    planar = (_planar_ss2(kind, shape, dt, krylov_m, lap, m_t, sigma1,
                          sigma2, kappa, bc, dtype, device)
              if reorth else None)
    if planar is not None:
        step, init, observe = planar
    else:
        rho = nlse_density(kind, m_t, sigma1=sigma1, sigma2=sigma2,
                           kappa=kappa)
        if bc != "noflux":
            neumann = lambda u: u
        elif dim == 3:
            neumann = bcs.neumann_no_velocity_3d
        else:
            neumann = bcs.neumann_no_velocity_2d

        def step(state, i):
            del i
            return neumann(nlse_mod.ss2_step(state, lap, rho, dt, m=krylov_m,
                                             reorth=reorth))

        def init(u0):
            return _as_tensor(u0, device).to(dtype)

        observe = lambda s: s

    meta = dict(equation=f"nlse_{kind}", integrator=integrator,
                shape=tuple(shape), Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m,
                dim=dim, bc=bc, variant=variant,
                planar_state=planar is not None, device=str(device),
                params=dict(sigma1=sigma1, sigma2=sigma2, kappa=kappa))
    return Problem(step, init, observe, meta)
