"""Global per-run analysis across a dataset directory.

Port of GlobalAnalyzer (scripts_sge_kge/global_analysis.py:11-334): load
every run_*.h5, compute per-run energy decomposition (with the per-system
potential forms), log-energy drift, norm and amplitude conservation, and
render a dataset-level dashboard. Builds on io_hdf5.load_run and the
classify potentials; snapshot loops are vectorized.

Potential-form quirk kept: klein_gordon uses 0.5 u^4 here
(global_analysis.py:124-125) while the classification dashboard uses
0.5 u^2 — the reference disagrees with itself, and each port follows its
own source file.

The port's copy of nlsolvers_tpu/analysis/global_runs.py, reading the
archives through the port's pipeline/io_hdf5.
"""

from pathlib import Path

import numpy as np

from nlsolvers_tpu_torch.analysis.classify import POTENTIALS
from nlsolvers_tpu_torch.pipeline import io_hdf5

__all__ = ["load_all_runs", "run_metrics", "analyze_all_runs",
           "global_dashboard"]

_GLOBAL_POTENTIALS = dict(POTENTIALS)
_GLOBAL_POTENTIALS["klein_gordon"] = lambda u: 0.5 * u ** 4


def load_all_runs(hdf5_dir, pattern="run_*.h5"):
    """{run_id: run dict} for every archive matching pattern."""
    runs = {}
    for path in sorted(Path(hdf5_dir).glob(pattern)):
        data = io_hdf5.load_run(path)
        runs[path.stem] = data
    return runs


def run_metrics(run, system_type):
    """Per-run metric dict (compute_metrics, global_analysis.py:90-163)."""
    grid, tinfo = run["grid"], run["time"]
    nx, ny = int(grid["nx"]), int(grid["ny"])
    dx = 2 * grid["Lx"] / (nx - 1)
    dy = 2 * grid["Ly"] / (ny - 1)
    dV = dx * dy
    u = np.asarray(run["u"])
    v = np.asarray(run["v"]) if "v" in run else None
    S = u.shape[0]

    kinetic = (0.5 * np.sum(v ** 2, axis=(1, 2)) * dV if v is not None
               else np.zeros(S))
    gx = np.gradient(u, dx, axis=1)
    gy = np.gradient(u, dy, axis=2)
    gradient = 0.5 * np.sum(gx ** 2 + gy ** 2, axis=(1, 2)) * dV
    if system_type not in _GLOBAL_POTENTIALS:
        raise ValueError(f"invalid system type {system_type!r}")
    potential = np.sum(_GLOBAL_POTENTIALS[system_type](u),
                       axis=(1, 2)) * dV

    total = kinetic + gradient + potential
    with np.errstate(divide="ignore", invalid="ignore"):
        logdiff = np.concatenate(
            [[np.nan], np.log10(np.abs(total[1:] - total[0]))])

    mass0 = np.sum(u[0] ** 2)
    amp0 = np.max(np.abs(u[0]))
    return {
        "time": np.linspace(0, tinfo["T"], S),
        "kinetic": kinetic, "gradient": gradient, "potential": potential,
        "total_energy": total, "energy_logdiff": logdiff,
        "norm": np.sum(u ** 2, axis=(1, 2)) / mass0,
        "max_amplitude": np.max(np.abs(u), axis=(1, 2)) / amp0,
        "metadata": run.get("metadata", {}),
        "snapshots": S, "dx": dx, "dy": dy,
    }


def analyze_all_runs(hdf5_dir, system_type, pattern="run_*.h5"):
    """{run_id: metrics} across a dataset directory."""
    return {rid: run_metrics(run, system_type)
            for rid, run in load_all_runs(hdf5_dir, pattern).items()}


def global_dashboard(metrics, out_path, title=""):
    """Dataset dashboard: energy components, drift, norm, amplitude across
    all runs (create_global_dashboard, global_analysis.py:164-333)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(13, 10))
    for rid, m in metrics.items():
        t = m["time"]
        axes[0, 0].plot(t, m["total_energy"], alpha=0.6, label=rid)
        axes[0, 1].plot(t, m["energy_logdiff"], alpha=0.6)
        axes[1, 0].plot(t, m["norm"], alpha=0.6)
        axes[1, 1].plot(t, m["max_amplitude"], alpha=0.6)
    axes[0, 0].set_title("total energy")
    axes[0, 1].set_title("log10 |E(t) - E(0)|")
    axes[1, 0].set_title("norm / norm0")
    axes[1, 1].set_title("max amplitude / amp0")
    if len(metrics) <= 8:
        axes[0, 0].legend(fontsize=7)
    fig.suptitle(title or f"{len(metrics)} runs")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
