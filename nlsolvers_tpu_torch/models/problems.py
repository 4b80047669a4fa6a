"""Problem constructors (port of nlsolvers_tpu/models/problems.py).

The NLSE family, as the JAX package's `nlse_problem` takes it: the SS2,
sEWI, fused-sEWI and Gautschi integrators; in 2D with the 5-point
Laplacian, its separated (Lx + Ly) form or, given a c(x) field, the
finite-volume div(c grad u); in 3D with the 7-point Laplacian or div(c grad
u); bc "noflux", "radiating" (2D) or "none". Grid conventions follow the
reference drivers: nx points span [-Lx, Lx] with dx = 2 Lx/(nx-1), and the
no-flux ghost cells are part of the field, copied after every step. The
two-step integrators keep (u, u_prev) as their state and take one SS2 step
at step index 1, as the reference's bootstrap (nlse_dev.hpp:206-209).

complex64 with an operator the fused kernels support takes the PLANAR path:
the state is (2, R, nx) float32 with R = ny in 2D and nz*ny in 3D (a pair
of them for the two-step integrators), and `observe` returns the complex
field of the grid's shape; its step carries `batched(B)`, the same step on
a batch of B lanes of the problem (parallel/batch.batched_step). Everything else (complex128, the radiating BC,
the separated operator, reorth=False) takes the complex path. With
config.resident_mode "auto", a 2D SS2 problem that ops/cuda/resident2d.py
supports takes one resident kernel per step instead, on complex state, as
the JAX package does. The problem lives on `device`, the card unless the
caller asks for the CPU.

The real-wave family (`realwave_problem`: sine-Gordon single, double and
hyperbolic, Klein-Gordon, phi-4; Gautschi or SV), stochastic phi-4 and
Boussinesq keep the real state (u, u_past), built by init(u0, v0) as
(u0, u0 - dt v0), and observe (u, (u - u_past)/dt). A real-wave Gautschi
step runs its matrix functions on -Lap, whose descriptor carries the
flipped sign, so float32 fields take the fused kernels at P=1 (two matrix
functions per step); in 3D float32 the ghost copy is the bc3d kernel, in
place on the fresh u.
"""

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.config import (default_complex_dtype,
                                        default_krylov_m, default_real_dtype,
                                        real_dtype_of)
from nlsolvers_tpu_torch.models import boussinesq as bq
from nlsolvers_tpu_torch.models import nlse as nlse_mod
from nlsolvers_tpu_torch.models import realwave as rw
from nlsolvers_tpu_torch.models.evolve import evolve
from nlsolvers_tpu_torch.models.nonlinearities import (NLSE_KINDS,
                                                       REALWAVE_KINDS,
                                                       nlse_density,
                                                       nlse_density_planar,
                                                       realwave_g)
from nlsolvers_tpu_torch.ops import boundaries as bcs
from nlsolvers_tpu_torch.ops import operators as ops
from nlsolvers_tpu_torch.ops.cuda.kick import kick_grid
from nlsolvers_tpu_torch.utils.profiling import annotate

__all__ = ["Problem", "nlse_problem", "realwave_problem",
           "stochastic_phi4_problem", "boussinesq_problem", "run",
           "planar_step"]


@dataclass(frozen=True)
class Problem:
    """A fully specified evolution problem.

    step:    (state, step_index) -> state
    init:    builds the initial state from fields (u0 [, v0])
    observe: state -> snapshot (a tensor, or the tuple (u, v))
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


_TWO_STEP = ("sewi", "sewi_fused", "gautschi")


def _nlse_operator(shape, dx, c_field, variant, rdtype, device):
    if variant == "separated":
        # the per-direction pair applied as Lx u + Ly u: the 2D no-flux
        # operator, its -3 corner diagonal included; no kernel descriptor
        if c_field is not None or len(shape) != 2:
            raise ValueError("variant='separated' is 2D isotropic only")
        apply_x, apply_y = ops.separated_laplacian_2d(shape, dx, dx,
                                                      dtype=rdtype,
                                                      device=device)
        return lambda u: apply_x(u) + apply_y(u)
    if c_field is not None:
        if len(shape) == 2:
            return ops.anisotropic_laplacian_2d(c_field, dx, dx,
                                                device=device)
        return ops.anisotropic_laplacian_3d(c_field, dx, variant=variant,
                                            device=device)
    if len(shape) == 2:
        return ops.laplacian_2d(shape, dx, dx, variant=variant, dtype=rdtype,
                                device=device)
    return ops.laplacian_3d(shape, dx, variant=variant, dtype=rdtype,
                            device=device)


def _two_step(integrator, planar):
    """The step after the bootstrap of a two-step integrator."""
    if integrator == "gautschi":
        return (nlse_mod.gautschi_step_planar if planar
                else nlse_mod.gautschi_step)
    fn = nlse_mod.sewi_step_planar if planar else nlse_mod.sewi_step
    return partial(fn, fuse_exp_sinc=integrator == "sewi_fused")


def planar_step(integrator, shape, dt, krylov_m, desc, rho, bc):
    """The step (state, i) -> state of `integrator` on PLANAR state, given
    the operator's kernel descriptor and a planar density: SS2 on (2, R,
    nx) float32, a two-step integrator on the pair (up, up_prev), its index
    1 the SS2 bootstrap (u_prev := u). The state may be a batch (B, 2, R,
    nx) (a pair of them) with a batched descriptor and density: the
    datagen engine's lanes, each stepped as alone.

    An SS2 step's closing half kick does the no-flux ghost copy
    (ops/cuda/kick.py); a two-step step copies it after: the plain copy in
    2D, bc3d in place in 3D. Each step runs inside the span `nls.step`
    (utils/profiling.annotate)."""
    grid = kick_grid(shape) if bc == "noflux" else None
    if integrator == "ss2":
        def step(up, i):
            del i
            with annotate("nls.step"):
                return nlse_mod.ss2_step_planar(up, desc, rho, dt,
                                                m=krylov_m, grid=grid)

        return step

    if bc != "noflux":
        neum = lambda up: up
    elif len(shape) == 3:
        from nlsolvers_tpu_torch.ops.cuda.bc3d import neumann_bc_planar_3d
        neum = lambda up: neumann_bc_planar_3d(up, shape)
    else:
        neum = bcs.neumann_no_velocity_2d
    two_step = _two_step(integrator, planar=True)

    def step(state, i):
        up, up_prev = state
        with annotate("nls.step"):
            if i == 1:      # bootstrap: one SS2 step, u_prev := u
                return nlse_mod.ss2_step_planar(up, desc, rho, dt,
                                                m=krylov_m, grid=grid), up
            u_new, u_prev_new = two_step(up, up_prev, desc, rho, dt,
                                         m=krylov_m)
            return neum(u_new), u_prev_new

    return step


def _planar_ss2(kind, shape, dt, krylov_m, lap, m_field, sigma1, sigma2,
                kappa, bc, dtype, integrator, device):
    """(step, init, observe) on PLANAR (2, R, nx) float32 state when the
    fused kernels support the operator, else None. Two-step state is a pair
    (up, up_prev) of planar tensors."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import supported_desc

    desc = getattr(lap, "kernel_desc", None)
    if (dtype != torch.complex64 or bc == "radiating"
            or not supported_desc(desc, shape, dtype)):
        return None
    nx = shape[-1]
    R = int(np.prod(shape[:-1]))
    m2 = _as_tensor(m_field, device).to(torch.float32).reshape(R, nx)
    rho = nlse_density_planar(kind, m2, sigma1=sigma1, sigma2=sigma2,
                              kappa=kappa)
    step = planar_step(integrator, shape, dt, krylov_m, desc, rho, bc)

    def batched(B):
        """This step on B lanes of the problem at once, (B, 2, R, nx)
        state: its descriptor's weights and its m stacked B times
        (parallel/batch.batched_step, JAX's vmap of the step)."""
        bdesc = {k: (torch.stack([v] * B) if isinstance(v, torch.Tensor)
                     else v) for k, v in desc.items()}
        brho = nlse_density_planar(kind, torch.stack([m2] * B),
                                   sigma1=sigma1, sigma2=sigma2, kappa=kappa)
        return planar_step(integrator, shape, dt, krylov_m, bdesc, brho, bc)

    step.batched = batched

    def init_single(u0):
        z = _as_tensor(u0, device)
        if z.is_complex():
            up = torch.stack([z.real, z.imag])
        elif tuple(z.shape) in ((2,) + tuple(shape), (2, R, nx)):
            up = z                               # packed or planar (re, im)
        else:
            up = torch.stack([z, torch.zeros_like(z)])
        return up.to(torch.float32).reshape(2, R, nx).contiguous()

    def to_complex(up):
        u = up.reshape((2,) + tuple(shape))
        return torch.complex(u[0], u[1])

    if integrator == "ss2":
        return step, init_single, to_complex

    def init(u0):
        up = init_single(u0)
        return (up, up)

    return step, init, lambda state: to_complex(state[0])


def _resident_ss2(kind, shape, dt, krylov_m, lap, m_field, sigma1, sigma2,
                  kappa, apply_bc, dtype, integrator, c_field, reorth,
                  device):
    """(step, init, observe) with one resident SS2 kernel per step
    (ops/cuda/resident2d.py) when config.resident_mode allows it and the
    configuration qualifies, else None. The state stays complex, as the
    JAX package's: a step stacks it to planar, runs the kernel and makes it
    complex again. The basis scratch is allocated once per problem."""
    from nlsolvers_tpu_torch.ops.cuda.resident2d import (ss2_resident_step,
                                                         supported_resident)

    if not config.use_resident():
        return None
    if (integrator != "ss2" or len(shape) != 2 or c_field is not None
            or dtype != torch.complex64 or not reorth):
        return None
    desc = getattr(lap, "kernel_desc", None)
    if not supported_resident(desc, shape, dtype, krylov_m, dt):
        return None
    mf32 = _as_tensor(m_field, device).to(torch.float32).contiguous()
    scratch = {}

    def step(state, i):
        del i
        out = ss2_resident_step(torch.stack([state.real, state.imag]), mf32,
                                desc, dt, krylov_m, kind=kind, sigma1=sigma1,
                                sigma2=sigma2, kappa=kappa,
                                apply_bc=apply_bc, scratch=scratch)
        return torch.complex(out[0], out[1])

    def init(u0):
        return _as_tensor(u0, device).to(dtype)

    return step, init, (lambda s: s)


def nlse_problem(kind, shape, Lx, dt, *, m_field=None, c_field=None,
                 sigma1=1.0, sigma2=-0.1, kappa=1.0, integrator="ss2",
                 krylov_m=None, dtype=default_complex_dtype,
                 variant="reference", apply_bc=True, reorth=True,
                 bc="noflux", device="cuda"):
    """NLSE family: i u_t + div(c grad u) + rho_kind(u) u = 0.

    kind in {"cubic", "cubic_quintic", "saturable"}; integrator in {"ss2",
    "sewi", "sewi_fused", "gautschi"}. `shape` is the full grid (ny, nx) or
    (nz, ny, nx), the domain [-Lx, Lx]^d. c_field selects the finite-volume
    operator. bc: "noflux" (the reference's production BC), "radiating"
    (the experimental radiating envelope, 2D only) or "none"; apply_bc=False
    is the legacy spelling of "none". variant: "reference" or "clean" (the
    diagonal of the no-flux operators), or "separated" (2D isotropic only:
    the per-direction pair Lx + Ly, the same matrix, on the complex path).
    m_field defaults to ZERO as in the reference drivers
    (nlse_cubic_driver.cpp:64). Krylov m defaults to 20 for 2D cubic, 15
    for the other 2D kinds (nlse_cubic_driver_2d.cpp:105) and 10 in 3D.
    `device` is where the state, the fields and the operator live: the card
    by default; asking for "cuda" without one raises torch's error, and
    nothing moves to the CPU.
    """
    if kind not in NLSE_KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    if bc not in ("noflux", "radiating", "none"):
        raise ValueError(f"unknown bc {bc!r}")
    if integrator not in ("ss2",) + _TWO_STEP:
        raise ValueError(f"unknown NLSE integrator {integrator!r}")
    if not apply_bc:
        bc = "none"
    dim = len(shape)
    if dim not in (2, 3):
        raise ValueError(f"shape must be (ny, nx) or (nz, ny, nx), got "
                         f"{tuple(shape)}")
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    if krylov_m is None:
        krylov_m = ({"cubic": 20, "cubic_quintic": 15, "saturable": 15}[kind]
                    if dim == 2 else 10)
    if m_field is None:
        m_field = np.zeros(shape)
    m_t = _as_tensor(m_field, device).to(rdtype)

    lap = _nlse_operator(shape, dx, c_field, variant, rdtype, device)
    if bc == "radiating":
        if dim != 2:
            raise ValueError("radiating BC is 2D only (boundaries.hpp:59)")
        neumann = lambda u: bcs.radiating_nlse_2d(u, m_t, dx, dx)
    elif bc == "noflux":
        neumann = (bcs.neumann_no_velocity_2d if dim == 2
                   else bcs.neumann_no_velocity_3d)
    else:
        neumann = lambda u: u

    # the resident kernel does the no-flux ghost copy itself; the radiating
    # BC and the separated operator take the other paths
    resident = (None if bc == "radiating" or variant == "separated" else
                _resident_ss2(kind, shape, dt, krylov_m, lap, m_t, sigma1,
                              sigma2, kappa, bc == "noflux", dtype,
                              integrator, c_field, reorth, device))
    planar = (_planar_ss2(kind, shape, dt, krylov_m, lap, m_t, sigma1,
                          sigma2, kappa, bc, dtype, integrator, device)
              if reorth and resident is None else None)
    rho = nlse_density(kind, m_t, sigma1=sigma1, sigma2=sigma2, kappa=kappa)

    def init_single(u0):
        return _as_tensor(u0, device).to(dtype)

    if resident is not None:
        step, init, observe = resident
    elif planar is not None:
        step, init, observe = planar
    elif integrator == "ss2":
        def step(state, i):
            del i
            return neumann(nlse_mod.ss2_step(state, lap, rho, dt, m=krylov_m,
                                             reorth=reorth))

        init, observe = init_single, (lambda s: s)
    else:
        two_step = _two_step(integrator, planar=False)

        def step(state, i):
            u, u_prev = state
            if i == 1:
                u_new, u_prev_new = nlse_mod.sewi_first_step(
                    u, lap, rho, dt, m=krylov_m, reorth=reorth)
            else:
                u_new, u_prev_new = two_step(u, u_prev, lap, rho, dt,
                                             m=krylov_m, reorth=reorth)
            return neumann(u_new), u_prev_new

        def init(u0):
            u = init_single(u0)
            return (u, u)

        observe = lambda state: state[0]

    meta = dict(equation=f"nlse_{kind}", integrator=integrator,
                shape=tuple(shape), Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m,
                dim=dim, bc=bc, variant=variant,
                planar_state=planar is not None, device=str(device),
                params=dict(sigma1=sigma1, sigma2=sigma2, kappa=kappa))
    return Problem(step, init, observe, meta)


def _negated(lap):
    """-lap, carrying lap's kernel descriptor with its sign flipped (the
    same dict entries otherwise, weight tensors shared), so that the fused
    Lanczos path takes it."""
    def omega2(u):
        return -lap(u)

    base = getattr(lap, "kernel_desc", None)
    if base is not None:
        omega2.kernel_desc = dict(base, sign=-base["sign"])
    return omega2


def _real_neumann(shape, rdtype, apply_bc):
    """The ghost copy after a real two-step step: the plain copy in 2D and
    in 3D float64; in 3D float32 the bc3d kernel on the (1, nz*ny, nx) view,
    in place on the fresh u_new (never on the tensor that becomes
    u_past)."""
    if not apply_bc:
        return lambda u: u
    if len(shape) == 2:
        return bcs.neumann_no_velocity_2d
    if rdtype != torch.float32:
        return bcs.neumann_no_velocity_3d
    from nlsolvers_tpu_torch.ops.cuda.bc3d import neumann_bc_planar_3d
    nz, ny, nx = shape

    def neumann(u):
        neumann_bc_planar_3d(u.view(1, nz * ny, nx), shape)
        return u

    return neumann


def _real_fields(shape, m_field, rdtype, device):
    if m_field is None:
        m_field = np.ones(shape)
    return _as_tensor(m_field, device).to(rdtype)


def _two_step_real(dt, rdtype, device):
    """(init, observe) of the real two-step state (u, u_past)."""
    def init(u0, v0=None):
        u0 = _as_tensor(u0, device).to(rdtype)
        v0 = (torch.zeros_like(u0) if v0 is None
              else _as_tensor(v0, device).to(rdtype))
        return (u0, u0 - dt * v0)

    def observe(state):
        u, u_past = state
        return u, (u - u_past) / dt

    return init, observe


def _check_shape(shape):
    if len(shape) not in (2, 3):
        raise ValueError(f"shape must be (ny, nx) or (nz, ny, nx), got "
                         f"{tuple(shape)}")


def realwave_problem(kind, shape, Lx, dt, *, m_field=None, c_field=None,
                     integrator="gautschi", krylov_m=default_krylov_m,
                     dtype=default_real_dtype, variant="reference",
                     apply_bc=True, reorth=True, device="cuda"):
    """Real-wave family: u_tt = div(c grad u) - m g_kind(u).

    kind in {"sine_gordon", "double_sine_gordon", "hyperbolic_sine_gordon",
    "klein_gordon", "phi4"}; integrator "gautschi" or "sv". The state is
    (u, u_past); init takes (u0, v0) with u_past = u0 - dt v0
    (kg_driver.cpp:71), observe gives (u, v) with v = (u - u_past)/dt
    (kg_driver.cpp:112). m_field defaults to ones. The Gautschi filter is
    "mod_cosine" for single sine-Gordon and "id_sqrt" for the rest. A
    float32 Gautschi step takes the fused kernels (2D: K1 / K1' and the
    pipe, 3D: pass1_3d and pass2, then combine, for each of its two matrix
    functions); float64 and reorth=False take the generic path, as in JAX.
    In 3D float32 every step ends in the bc3d ghost copy (the JAX package
    runs its kernel only on TPU-aligned grids; both equal the plain copy).
    SV applies the plain Laplacian, no Lanczos kernel.
    """
    if kind not in REALWAVE_KINDS:
        raise ValueError(f"unknown real-wave kind {kind!r}")
    if integrator not in ("gautschi", "sv"):
        raise ValueError(f"unknown real-wave integrator {integrator!r}")
    _check_shape(shape)
    rdtype = real_dtype_of(dtype)
    dim, nx = len(shape), shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    m_t = _real_fields(shape, m_field, rdtype, device)
    g = realwave_g(kind)
    lap = _nlse_operator(shape, dx, c_field, variant, rdtype, device)
    # all the matrix functions take |lambda|: the step runs on -Lap (PSD)
    omega2 = _negated(lap)
    neumann = _real_neumann(shape, rdtype, apply_bc)
    filter_func = rw.gautschi_filter(kind)

    if integrator == "gautschi":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = rw.gautschi_step(
                u, u_past, omega2, m_t, g, dt, m=krylov_m,
                filter_func=filter_func, reorth=reorth)
            return neumann(u_new), u_past_new
    else:
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = rw.sv_step(u, u_past, lap, m_t, g, dt)
            return neumann(u_new), u_past_new

    init, observe = _two_step_real(dt, rdtype, device)
    meta = dict(equation=kind, integrator=integrator, shape=tuple(shape),
                Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m, dim=dim,
                filter=filter_func, variant=variant, device=str(device))
    return Problem(step, init, observe, meta)


def stochastic_phi4_problem(shape, Lx, dt, *, m_field=None,
                            noise_strength=0.1, seed=0,
                            dtype=default_real_dtype, variant="reference",
                            apply_bc=True, device="cuda"):
    """Stochastic phi-4 with SV stepping (device SP4Solver parity).

    Step i draws its noise xi ~ N(0, 1) on the problem's device from a
    torch.Generator seeded from (seed, i) (models/realwave.stochastic_noise):
    one seed gives the same trajectory, unlike the reference's
    time(nullptr)+idx seeding (stochastic_phi4.cuh:27). The JAX package
    draws from fold_in(PRNGKey(seed), i) instead: same law, other numbers.
    """
    _check_shape(shape)
    rdtype = real_dtype_of(dtype)
    dim, nx = len(shape), shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    m_t = _real_fields(shape, m_field, rdtype, device)
    lap = _nlse_operator(shape, dx, None, variant, rdtype, device)
    neumann = _real_neumann(shape, rdtype, apply_bc)
    gen = torch.Generator(device=device)

    def step(state, i):
        u, u_past = state
        xi = rw.stochastic_noise(seed, i, u, generator=gen)
        u_new, u_past_new = rw.stochastic_sv_step(
            u, u_past, xi, lap, m_t, dt, noise_strength)
        return neumann(u_new), u_past_new

    init, observe = _two_step_real(dt, rdtype, device)
    meta = dict(equation="stochastic_phi4", integrator="sv",
                shape=tuple(shape), Lx=Lx, dx=dx, dt=dt, dim=dim,
                noise_strength=noise_strength, seed=seed, variant=variant,
                device=str(device))
    return Problem(step, init, observe, meta)


def boussinesq_problem(shape, Lx, dt, *, integrator="gautschi",
                       krylov_m=default_krylov_m, dtype=default_real_dtype,
                       variant="reference", apply_bc=True, reorth=True,
                       device="cuda"):
    """Boussinesq: u_tt - Lap u + 3 (u^2)_xx - u_xxxx = 0 on an (ny, nx)
    grid, integrator "gautschi" or "sv" (the stiff SV step, given the
    operator L = -Lap - d4/dx4 itself, as JAX's problem passes it). The
    operator has no descriptor: the generic Krylov path."""
    if integrator not in ("gautschi", "sv"):
        raise ValueError(f"unknown Boussinesq integrator {integrator!r}")
    if len(shape) != 2:
        raise ValueError(f"Boussinesq is 2D, got shape {tuple(shape)}")
    rdtype = real_dtype_of(dtype)
    nx = shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    omega2 = bq.boussinesq_omega2(shape, dx, dtype=rdtype, variant=variant,
                                  device=device)
    neumann = _real_neumann(shape, rdtype, apply_bc)

    if integrator == "gautschi":
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = bq.gautschi_step(u, u_past, omega2, dx, dt,
                                                 m=krylov_m, reorth=reorth)
            return neumann(u_new), u_past_new
    else:
        def step(state, i):
            del i
            u, u_past = state
            u_new, u_past_new = bq.stiff_sv_step(u, u_past, omega2, dx, dt)
            return neumann(u_new), u_past_new

    init, observe = _two_step_real(dt, rdtype, device)
    meta = dict(equation="boussinesq", integrator=integrator,
                shape=tuple(shape), Lx=Lx, dx=dx, dt=dt, krylov_m=krylov_m,
                dim=2, variant=variant, device=str(device))
    return Problem(step, init, observe, meta)
