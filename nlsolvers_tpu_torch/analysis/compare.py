"""Integrator comparison studies — the reference's de-facto integration suite.

In-process port of the (nx x dt) study harness
(finalized_scripts/compare_integrators_nlse_2d.py:18-86 +
compare_utils_complex_2d.py NLSEIntegratorStudy / WaveIntegratorStudy):
one high-resolution IC is downsampled to every study grid, each integrator
runs the full (nx x dt) matrix, and every run is scored by the conservation
gate (analysis/conservation.py) plus walltime — yielding convergence and
work-precision tables.

The port's counterpart of nlsolvers_tpu/analysis/compare.py: each cell is
one of the port's problems (models/problems.py) on `device`, the card
unless the caller asks for the CPU, so a complex64 NLSE cell runs the
planar kernels (K1'/K2'/K3 and kick_bc with c(x)) and a float32 real-wave
Gautschi cell the P=1 kernels. The trajectory is read back with
`.cpu().numpy()` and scored in numpy on the host, as JAX's is; the
walltime window is JAX's too, from before problems.run to after the
conservation analysis, so the readback inside it is the sync.
"""

import time

import numpy as np
import torch

from nlsolvers_tpu_torch.analysis import conservation as cons
from nlsolvers_tpu_torch.models import problems
from nlsolvers_tpu_torch.pipeline import downsample as ds

__all__ = ["integrator_study", "pairwise_solution_difference"]


def _downsample_ic(field, nx, dim, Lx):
    if field.shape[-1] == nx:
        return field
    return ds.downsample_interpolation(field[None], (nx,) * dim,
                                       *((Lx,) * dim))[0]


def _build(family, kind, integrator, shape, Lx, dt, m, c, krylov_m, dtype,
           device):
    if family == "nlse":
        return problems.nlse_problem(kind, shape, Lx, dt, m_field=m,
                                     c_field=c, integrator=integrator,
                                     krylov_m=krylov_m, dtype=dtype,
                                     device=device)
    return problems.realwave_problem(kind, shape, Lx, dt, m_field=m,
                                     c_field=c, integrator=integrator,
                                     krylov_m=krylov_m, dtype=dtype,
                                     device=device)


def integrator_study(family, kind, u0_high, *, integrators, nx_values,
                     dt_values, T, Lx, v0_high=None, m_high=None,
                     c_high=None, num_snapshots=11, krylov_m=10,
                     dtype=None, m_of=None, c_of=None, keep_traj=None,
                     device="cuda"):
    """Run every (integrator, nx, dt) cell and score it.

    u0_high (and optionally v0_high/m_high/c_high) live on the finest grid
    (max(nx_values) per axis) and are interpolation-downsampled to each study
    grid, like _prepare_high_resolution_inputs does. Returns
    {(integrator, nx, dt): {metrics..., walltime, final_snapshot}}.

    keep_traj: optional predicate (nx, dt) -> bool; cells where it returns
    True also keep the full snapshot stack under metrics["trajectory"]
    (the reference keeps min-dt trajectories on disk for its snapshot and
    solution-difference figures, compare_utils_complex_2d.py:828-833).

    dtype defaults to torch.complex128 (NLSE) / torch.float64 (real wave),
    as JAX's; those take the generic Krylov path, and complex64 / float32
    take the kernels. device: where every cell's problem runs.
    """
    if dtype is None:
        dtype = torch.complex128 if family == "nlse" else torch.float64
    dim = u0_high.ndim
    results = {}
    for nx in nx_values:
        shape = (nx,) * dim
        spacings = (2.0 * Lx / (nx - 1),) * dim
        u0 = _downsample_ic(u0_high, nx, dim, Lx)
        v0 = (_downsample_ic(v0_high, nx, dim, Lx)
              if v0_high is not None else None)
        m = (_downsample_ic(m_high, nx, dim, Lx)
             if m_high is not None else None)
        c = (_downsample_ic(c_high, nx, dim, Lx)
             if c_high is not None else None)
        for dt in dt_values:
            nt = max(1, int(round(T / dt)))
            freq = max(1, nt // (num_snapshots - 1))
            snaps_n = nt // freq + 1
            T_actual = (snaps_n - 1) * freq * dt
            for integrator in integrators:
                prob = _build(family, kind, integrator, shape, Lx, dt,
                              m, c, krylov_m, dtype, device)
                state0 = (prob.init(u0) if family == "nlse"
                          else prob.init(u0, v0))
                t0 = time.time()
                out = problems.run(prob, state0, snaps_n, freq)
                if family == "nlse":
                    traj = out.cpu().numpy()
                    metrics = cons.analyze_nlse_trajectory(
                        traj, spacings, T_actual)
                else:
                    traj, vel = out[0].cpu().numpy(), out[1].cpu().numpy()
                    metrics = cons.analyze_realwave_trajectory(
                        traj, vel, spacings, T_actual, m=m, c=c)
                walltime = time.time() - t0
                metrics.update(walltime=walltime, nx=nx, dt=dt, nt=nt,
                               integrator=integrator,
                               final_snapshot=traj[-1])
                if keep_traj is not None and keep_traj(nx, dt):
                    metrics["trajectory"] = traj
                results[(integrator, nx, dt)] = metrics
    return results


def pairwise_solution_difference(results, integrators, norm="l2"):
    """Per-(nx, dt) relative difference between two integrators' final
    snapshots — the scoring core of the reference's solution-difference
    study (compare_utils_complex_2d.py:651-752); the figure + animation
    deliverables live in analysis/study.py."""
    a, b = integrators
    out = {}
    for key, ra in results.items():
        integ, nx, dt = key
        if integ != a:
            continue
        rb = results.get((b, nx, dt))
        if rb is None:
            continue
        fa, fb = ra["final_snapshot"], rb["final_snapshot"]
        denom = np.linalg.norm(fa.ravel())
        diff = np.linalg.norm((fa - fb).ravel())
        out[(nx, dt)] = diff / denom if denom > 0 else np.nan
    return out
