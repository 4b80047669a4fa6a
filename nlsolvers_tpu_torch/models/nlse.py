"""NLSE time steppers (port of nlsolvers_tpu/models/nlse.py).

tau = i*dt throughout, as in the reference drivers (nlse_cubic_solver.hpp:
58-59). Parity map:
  ss2_step       <-> NLSESolver::step (nlse_cubic_solver.hpp:54-74)
  sewi_step      <-> NLSESolverDevice::step_sewi (nlse_dev.hpp:205-238):
                     u' = exp(2 tau L) u_prev - 2 tau exp(tau L) sinc(dt L) B(u)
  gautschi_step  <-> NLSECubicGautschiSolver::step
                     (nlse_cubic_gautschi_solver.hpp:17-40), flagged there as
                     for comparison only, and its "plus" convention
                     (nlse_cubic_quintic_gautschi_solver.hpp:16-41)

Each has a planar form on (2, R, nx) float32 state for the fused kernels
(`*_planar`, given the operator's kernel descriptor and a planar density).
`ss2_step_planar_sharded`, `sewi_step_planar_sharded` and
`gautschi_step_planar_sharded` are the same steps on a sharded planar state
(a list of local blocks, parallel/shards.py) with a shard descriptor, the
matrix functions through parallel/lanczos.py. The planar SS2 steps
take both half kicks, density included, as one pass each
(ops/cuda/kick.py), the closing one with the no-flux ghost copy folded in
when the caller passes the block's grid; the two-step integrators' source
terms are plain torch ops. Every planar step also takes a batch (B, 2, R,
nx) of lanes, the datagen engine's form (a sharded step: (B, 2, R, nx)
blocks).
"""

import numpy as np
import torch

from nlsolvers_tpu_torch.config import default_krylov_m
from nlsolvers_tpu_torch.ops.cuda.kick import (phase_kick_bc_planar,
                                               phase_kick_planar)
from nlsolvers_tpu_torch.ops.krylov import MATFUNCS, expm_apply, matfunc_apply

__all__ = ["ss2_step", "ss2_step_planar", "ss2_step_planar_sharded",
           "phase_kick_planar", "sewi_step",
           "sewi_step_planar", "sewi_step_planar_sharded", "gautschi_step",
           "gautschi_step_planar", "gautschi_step_planar_sharded",
           "sewi_first_step", "gautschi_phi1_bootstrap"]


def _fields(fn, mesh, *fields):
    """fn over the fields, or, with a mesh, over each shard's blocks of
    sharded fields (lists): the pointwise terms of the generic steps."""
    if mesh is None:
        return fn(*fields)
    return [fn(*blocks) for blocks in zip(*fields)]


def _kick(u, rho_fn, tau, mesh):
    return _fields(lambda r, v: torch.exp(0.5 * tau * r) * v, mesh,
                   rho_fn(u), u)


def ss2_step(u, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
             mesh=None):
    """One SS2 Strang step: half nonlinear phase, full linear expm, half
    phase. With `mesh` (the JAX package's axis_names), u is a sharded field,
    lap and rho_fn map sharded fields to sharded fields, and the matrix
    function is the sharded generic Lanczos (ops/krylov.py)."""
    tau = 1j * dt
    u = _kick(u, rho_fn, tau, mesh)
    u = expm_apply(lap, u, tau, m=m, reorth=reorth, mesh=mesh)
    return _kick(u, rho_fn, tau, mesh)


def ss2_step_planar(up, desc, rho_fn, dt, m=default_krylov_m, grid=None):
    """SS2 on PLANAR state (2, R, nx) float32 (R = ny in 2D, nz*ny in 3D):
    the fused-kernel path. `desc` is the operator's kernel descriptor;
    `rho_fn` a planar density (nlse_density_planar). With `grid`
    (ops/cuda/kick.kick_grid) the closing half kick also does the no-flux
    ghost copy of that block; without it the step copies no ghost cells.

    `up` may be a batch (B, 2, R, nx): every lane steps in the same
    launches (batched kicks, Lanczos kernels, one batched eigh), with a
    batched descriptor (ops/operators.batched_aniso_laplacian_2d / _3d, or
    the shared iso one) and a density whose m field is (B, R, nx)."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import matfunc_apply_planar

    up = phase_kick_bc_planar(up, rho_fn, 0.5 * dt)
    up = matfunc_apply_planar(up, desc, 1j * dt, "exp", m)
    return phase_kick_bc_planar(up, rho_fn, 0.5 * dt, grid)


def ss2_step_planar_sharded(ups, desc, rho_fns, dt, m=default_krylov_m,
                            grids=None):
    """ss2_step_planar on a sharded planar state: `ups` holds each shard's
    (2, R, nx) float32 block, `rho_fns` each shard's planar density and
    `grids` (or None: no ghost copy) each shard's block grid with its global
    offsets. The kicks run per shard; the matrix function is the sharded
    Lanczos of the shard descriptor `desc` (parallel/lanczos.py), then K3
    combine per shard."""
    from nlsolvers_tpu_torch.parallel.lanczos import matfunc_apply_sharded
    from nlsolvers_tpu_torch.parallel.shards import per_shard

    mesh = desc["mesh"]
    grids = grids or [None] * len(ups)
    ups = per_shard(mesh, lambda k: phase_kick_bc_planar(
        ups[k], rho_fns[k], 0.5 * dt))
    ups = matfunc_apply_sharded(ups, desc, 1j * dt, "exp", m)
    return per_shard(mesh, lambda k: phase_kick_bc_planar(
        ups[k], rho_fns[k], 0.5 * dt, grids[k]))


def _B(u, rho_fn, mesh=None):
    """sEWI source term B(u) = -rho(u) u (nlse.cuh:71-84)."""
    return _fields(lambda r, v: -r * v, mesh, rho_fn(u), u)


def _mul_i_planar(up):
    """i * u on PLANAR ([B,] 2, R, nx) state: (re, im) -> (-im, re), the
    pair on axis -3."""
    return torch.stack([-up[..., 1, :, :], up[..., 0, :, :]], dim=-3)


def _B_planar(up, rho_fn):
    """B(u) = -rho(u) u on PLANAR ([B,] 2, R, nx) state: the density
    ([B,] R, nx) broadcast over the (re, im) pair."""
    return -rho_fn(up).unsqueeze(-3) * up


def _exp_sinc(tau, dt):
    """exp(tau lam) sinc(dt lam) as one matrix function. Asymmetric on
    purpose: the exp factor takes the imaginary time tau, the sinc factor
    the REAL dt, as in the sequential form sinc(dt L) then exp(tau L); the
    time the caller passes is ignored."""
    return lambda _t, lam: MATFUNCS["exp"](tau, lam) * MATFUNCS["sinc"](dt,
                                                                        lam)


def sewi_step_planar(up, up_prev, desc, rho_fn, dt, m=default_krylov_m,
                     fuse_exp_sinc=False):
    """One sEWI step on PLANAR (2, R, nx) float32 state; returns (new, up).
    Same semantics as sewi_step; the final u' = e2 - 2 tau e1 is a planar
    i-rotation. A batch (B, 2, R, nx) with a batched descriptor and density
    (as ss2_step_planar takes it) steps every lane in the same launches."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import matfunc_apply_planar

    tau = 1j * dt
    Bp = _B_planar(up, rho_fn)
    if fuse_exp_sinc:
        e1 = matfunc_apply_planar(Bp, desc, tau, _exp_sinc(tau, dt), m)
    else:
        psi = matfunc_apply_planar(Bp, desc, dt, "sinc", m)
        e1 = matfunc_apply_planar(psi, desc, tau, "exp", m)
    e2 = matfunc_apply_planar(up_prev, desc, 2.0 * tau, "exp", m)
    return e2 - (2.0 * dt) * _mul_i_planar(e1), up


def gautschi_step_planar(up, up_prev, desc, rho_fn, dt, m=default_krylov_m,
                         convention="cubic"):
    """gautschi_step on PLANAR state, or a batch of them as
    sewi_step_planar takes it; returns (new, up). Same two sign conventions
    as the complex form."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import matfunc_apply_planar

    sgn = -1.0 if convention == "cubic" else 1.0
    tau = 1j * dt
    Bp = _B_planar(up, rho_fn)
    psi = matfunc_apply_planar(Bp, desc, dt, "sinc", m)
    e1 = matfunc_apply_planar(psi, desc, sgn * tau, "exp", m)
    e2 = matfunc_apply_planar(up_prev, desc, sgn * 2.0 * tau, "exp", m)
    return e2 - (sgn * 2.0 * dt) * _mul_i_planar(e1), up


def _two_step_sharded(ups, ups_prev, desc, rho_fns, dt, m, sgn, fused):
    """The sEWI (sgn = 1) or Gautschi (sgn = -1, the "cubic" convention)
    step on a sharded planar state, in the arithmetic order of
    sewi_step_planar / gautschi_step_planar: the source term per shard, the
    matrix functions sharded, the final e2 - 2 sgn tau e1 per shard."""
    from nlsolvers_tpu_torch.parallel.lanczos import matfunc_apply_sharded
    from nlsolvers_tpu_torch.parallel.shards import per_shard

    mesh = desc["mesh"]
    tau = 1j * dt
    Bp = per_shard(mesh, lambda k: _B_planar(ups[k], rho_fns[k]))
    if fused:
        e1 = matfunc_apply_sharded(Bp, desc, tau, _exp_sinc(tau, dt), m)
    else:
        psi = matfunc_apply_sharded(Bp, desc, dt, "sinc", m)
        e1 = matfunc_apply_sharded(psi, desc, sgn * tau, "exp", m)
    e2 = matfunc_apply_sharded(ups_prev, desc, sgn * 2.0 * tau, "exp", m)
    return per_shard(mesh, lambda k: e2[k] - (sgn * 2.0 * dt) * _mul_i_planar(
        e1[k])), ups


def sewi_step_planar_sharded(ups, ups_prev, desc, rho_fns, dt,
                             m=default_krylov_m, fuse_exp_sinc=False):
    """sewi_step_planar on a sharded planar state: `ups`, `ups_prev` hold
    each shard's ([B,] 2, R, nx) float32 block, `rho_fns` each shard's
    planar density, `desc` a shard descriptor. Returns (new, ups); the
    ghost copy is the caller's, as for sewi_step_planar."""
    return _two_step_sharded(ups, ups_prev, desc, rho_fns, dt, m, 1.0,
                             fuse_exp_sinc)


def gautschi_step_planar_sharded(ups, ups_prev, desc, rho_fns, dt,
                                 m=default_krylov_m):
    """gautschi_step_planar ("cubic" convention, the datagen engine's) on a
    sharded planar state, as sewi_step_planar_sharded takes it."""
    return _two_step_sharded(ups, ups_prev, desc, rho_fns, dt, m, -1.0,
                             False)


def sewi_step(u, u_prev, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
              fuse_exp_sinc=False, mesh=None):
    """One sEWI (exponential wave integrator) step; returns (u_new, u).

      psi   = sinc(dt L) B(u)        (real time in the sinc)
      u_new = exp(2 i dt L) u_prev - 2 (i dt) exp(i dt L) psi

    With `fuse_exp_sinc` the product exp(i dt L) sinc(dt L) is one matrix
    function of L from one Krylov projection of B(u): 2 Lanczos runs per
    step instead of 3, not bit-identical to the sequential form. `mesh` as
    ss2_step takes it.
    """
    tau = 1j * dt
    kw = dict(m=m, reorth=reorth, mesh=mesh)
    if fuse_exp_sinc:
        e1 = matfunc_apply(lap, _B(u, rho_fn, mesh), tau, _exp_sinc(tau, dt),
                           **kw)
    else:
        psi = matfunc_apply(lap, _B(u, rho_fn, mesh), dt, "sinc", **kw)
        e1 = expm_apply(lap, psi, tau, **kw)
    e2 = expm_apply(lap, u_prev, 2.0 * tau, **kw)
    return _fields(lambda a, b: a - 2.0 * tau * b, mesh, e2, e1), u


def sewi_first_step(u, lap, rho_fn, dt, m=default_krylov_m, reorth=True,
                    mesh=None):
    """sEWI bootstrap: u_prev := u, then one SS2 step (nlse_dev.hpp:
    206-209)."""
    return ss2_step(u, lap, rho_fn, dt, m=m, reorth=reorth, mesh=mesh), u


def gautschi_step(u, u_prev, lap, rho_fn, dt, m=default_krylov_m,
                  reorth=True, convention="cubic", mesh=None):
    """The reference host's comparison 'Gautschi' NLSE step; returns
    (u_new, u). Two sign conventions:
      "cubic" (nlse_cubic_gautschi_solver.hpp:17-40):
        u' = exp(-2 tau L) u_prev + 2 tau exp(-tau L) sinc(dt L) B(u)
      "plus" (nlse_cubic_quintic_gautschi_solver.hpp:16-41,
        nlse_saturating_gautschi_solver.hpp:11-44):
        u' = exp(+2 tau L) u_prev - 2 tau exp(+tau L) sinc(dt L) B(u)
    `mesh` as ss2_step takes it.
    """
    tau = 1j * dt
    sgn = -1.0 if convention == "cubic" else 1.0
    kw = dict(m=m, reorth=reorth, mesh=mesh)
    psi = matfunc_apply(lap, _B(u, rho_fn, mesh), dt, "sinc", **kw)
    e1 = expm_apply(lap, psi, sgn * tau, **kw)
    e2 = expm_apply(lap, u_prev, sgn * 2.0 * tau, **kw)
    return _fields(lambda a, b: a - sgn * 2.0 * tau * b, mesh, e2, e1), u


def gautschi_phi1_bootstrap(u, lap, rho_fn, dt, bc_fn=None, pre_steps=10,
                            m=default_krylov_m, reorth=True):
    """First-order Gautschi bootstrap: `pre_steps` substeps of
    u <- exp(tau_s L) u - tau_s^2 phi1(tau_s^2 L) B(u),  tau_s = i dt/pre_steps
    (nlse_cubic_quintic_gautschi_driver.cpp:103-131), the phi1 term as one
    Krylov projection. tau_s and tau_s^2 are rounded to the state's
    precision, as the JAX package's numpy scalars are."""
    cdtype = np.complex64 if u.dtype == torch.complex64 else np.complex128
    taus = np.asarray(1j * dt / pre_steps, cdtype)
    taus2 = complex(taus * taus)
    taus = complex(taus)
    for _ in range(pre_steps):
        filt = matfunc_apply(lap, _B(u, rho_fn), taus2, "phi1", m=m,
                             reorth=reorth)
        u = expm_apply(lap, u, taus, m=m, reorth=reorth) - taus2 * filt
        if bc_fn is not None:
            u = bc_fn(u)
    return u
