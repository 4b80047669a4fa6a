"""Per-trajectory conservation metrics — the repo's own accuracy gate.

Port of the integrator-study analysis (_analyze_trajectory,
compare_utils_complex_2d.py:302-381): mass and Hamiltonian time series with
log10 relative drift, NaN truncation from the first non-finite snapshot, and
a stability verdict. These are the numbers the reference uses to decide
whether a run counts (SURVEY.md section 6: "mass/Hamiltonian log10 relative
drift per trajectory; NaN => unstable").

The port's copy of nlsolvers_tpu/analysis/conservation.py (numpy on the
host, as there).
"""

import numpy as np

from nlsolvers_tpu_torch.analysis import energy as en

__all__ = ["analyze_nlse_trajectory", "analyze_realwave_trajectory",
           "log10_rel_error"]

_FLOOR = 1e-16


def log10_rel_error(series, ref):
    """log10(|x_t - x_0| / |x_0|) with the reference's floors: entries <=
    1e-16 clamp to -16, entry 0 stays NaN (compare_utils:348-365)."""
    out = np.full(np.shape(series), np.nan, dtype=np.float64)
    if not np.isfinite(ref):
        return out
    with np.errstate(divide="ignore", invalid="ignore"):
        if abs(ref) > 1e-15:
            raw = np.abs(series - ref) / abs(ref)
        else:
            raw = np.where(np.abs(series - ref) < 1e-15, 0.0, np.inf)
        tail = raw[1:]
        valid = (tail > _FLOOR) & np.isfinite(tail)
        out[1:][valid] = np.log10(tail[valid])
        out[1:][~valid & (tail <= _FLOOR) & np.isfinite(tail)] = -16.0
    return out


def _truncate_nonfinite(traj):
    """Index of the first snapshot containing a non-finite value (or len)."""
    flat = traj.reshape(traj.shape[0], -1)
    bad = ~np.isfinite(flat).all(axis=1)
    return int(np.argmax(bad)) if bad.any() else traj.shape[0]


def _pack(times, mass, h_parts, stable):
    h_total = sum(h_parts.values())
    m0, h0 = mass[0], h_total[0]
    raw_h = (np.abs(h_total - h0) / abs(h0)
             if np.isfinite(h0) and abs(h0) > 1e-15 else
             np.full_like(h_total, np.nan))
    max_h = np.nanmax(raw_h[1:]) if stable and raw_h[1:].size else np.nan
    return {
        "time_points": times,
        "mass": mass,
        "mass_log10_rel_error": log10_rel_error(mass, m0),
        "hamiltonian_total": h_total,
        "hamiltonian_log10_rel_error": log10_rel_error(h_total, h0),
        "max_abs_hamiltonian_rel_error": max_h if stable else np.nan,
        **{f"hamiltonian_{k}": v for k, v in h_parts.items()},
        "simulation_stable": stable,
    }


def analyze_nlse_trajectory(traj, spacings, T):
    """Metrics dict for a complex snapshot stack (S, *grid)."""
    traj = np.asarray(traj)
    S = traj.shape[0]
    cut = _truncate_nonfinite(traj)
    stable = cut == S
    times = np.linspace(0, T, S)

    mass = np.full(S, np.nan)
    grad = np.full(S, np.nan)
    pot = np.full(S, np.nan)
    ok = traj[:cut]
    if cut:
        mass[:cut] = en.mass_nlse(ok, spacings)
        grad[:cut], pot[:cut] = en.hamiltonian_nlse(ok, spacings)
    stable = stable and np.isfinite(mass[:cut]).all() \
        and np.isfinite(grad[:cut] + pot[:cut]).all()
    return _pack(times, mass, {"gradient": grad, "potential": pot}, stable)


def analyze_realwave_trajectory(traj, vel, spacings, T, m=None, c=None):
    """Metrics dict for a real (u, v) snapshot stack pair (S, *grid)."""
    traj = np.asarray(traj)
    vel = np.asarray(vel)
    S = traj.shape[0]
    cut = min(_truncate_nonfinite(traj), _truncate_nonfinite(vel))
    stable = cut == S
    times = np.linspace(0, T, S)

    mass = np.full(S, np.nan)
    kin = np.full(S, np.nan)
    grad = np.full(S, np.nan)
    pot = np.full(S, np.nan)
    if cut:
        mass[:cut] = en.mass_nlse(traj[:cut], spacings)
        kin[:cut], grad[:cut], pot[:cut] = en.hamiltonian_kge_u_cubed(
            traj[:cut], vel[:cut], spacings, m=m, c=c)
    stable = stable and np.isfinite(mass[:cut]).all() \
        and np.isfinite(kin[:cut] + grad[:cut] + pot[:cut]).all()
    return _pack(times, mass,
                 {"kinetic": kin, "gradient": grad, "potential": pot},
                 stable)
