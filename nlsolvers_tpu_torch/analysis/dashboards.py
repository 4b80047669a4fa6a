"""Per-directory ensemble dashboards over HDF5 archives + runner CLI.

The figure layer over analysis/ensemble — the deliverable the reference's
process_h5/ensemble_processing.py produces per (dims, problem_type) group
(generate_collective_stats :232-478, plot_case_snapshots :939-1092,
plot_field_info :746-934). For every group found under a dataset directory
this writes:

  energy_plots_{D}D_{type}.png     2x2: per-run conservation traces,
                                   max-deviation histogram, normalized
                                   amplitude band, mean energy components
  case_snapshots_{D}D_{type}.png   best/median/worst-conservation runs,
                                   first/mid/last |u| frames
  field_info_{D}D_{type}.png       m/c field statistics vs energy drift
  collective_stats.json            the aggregate table

The reference scatters files over mpi4py ranks and re-reads everything per
plot; here ensemble.process_files threads one pass for the time series and
only the few selected snapshot cases are re-opened.

The port's copy of nlsolvers_tpu/analysis/dashboards.py; h5py is
imported where an archive is opened (pipeline/io_hdf5.h5py_or_raise).
CLI: `python -m nlsolvers_tpu_torch.analysis.dashboards BASE_DIR`.
"""

import argparse
import json
from pathlib import Path

import numpy as np

from nlsolvers_tpu_torch.analysis import ensemble as ens
from nlsolvers_tpu_torch.pipeline.io_hdf5 import h5py_or_raise

__all__ = ["ensemble_dashboard", "energy_dashboard", "case_snapshots",
           "field_info", "main"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _group(results):
    groups = {}
    for r in results:
        groups.setdefault((r["dims"], r["problem_type"]), []).append(r)
    return groups


def energy_dashboard(rows, path, group_key, max_traces=40):
    """The 2x2 collective energy figure (ensemble_processing.py:291-478)."""
    plt = _plt()
    dims, ptype = group_key
    clean = [r for r in rows if not r["has_nan"] and "energies" in r]
    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    ax1, ax2, ax3, ax4 = axes.ravel()

    for r in clean[:max_traces]:
        ax1.semilogy(r["times"], np.maximum(r["energy_conservation"], 1e-18),
                     linewidth=0.7, alpha=0.5)
    ax1.set_title(f"Energy conservation ({dims}D {ptype})")
    ax1.set_xlabel("$t$")
    ax1.set_ylabel(r"$|E(t)-E_0|/|E_0|$")
    ax1.grid(True, which="both", linestyle=":", alpha=0.3)

    devs = np.array([r["max_energy_deviation"] for r in rows
                     if np.isfinite(r.get("max_energy_deviation", np.nan))
                     and r["max_energy_deviation"] > 0])
    if devs.size:
        bins = np.logspace(np.log10(devs.min()), np.log10(devs.max()) + 1e-9,
                           min(25, max(5, devs.size)))
        ax2.hist(devs, bins=bins, color="steelblue", edgecolor="k",
                 linewidth=0.4)
        ax2.set_xscale("log")
        ax2.text(0.95, 0.95,
                 f"n={devs.size}\nmedian={np.median(devs):.2e}\n"
                 f"worst={devs.max():.2e}",
                 transform=ax2.transAxes, ha="right", va="top", fontsize=9,
                 bbox=dict(boxstyle="round", fc="w", alpha=0.8))
    ax2.set_title("Distribution of max energy deviation")
    ax2.set_xlabel(r"$\max_t |E(t)-E_0|/|E_0|$")
    ax2.set_ylabel("count")
    ax2.grid(True, linestyle=":", alpha=0.3)

    # normalized amplitude traces + median/quartile band over the dominant
    # snapshot-count group (:340-390)
    by_len = {}
    for r in clean:
        by_len.setdefault(len(r["times"]), []).append(r)
    if by_len:
        dominant = max(by_len.values(), key=len)
        norm = np.array([r["max_amplitudes"] / r["max_amplitudes"][0]
                         for r in dominant if r["max_amplitudes"][0] > 0])
        t = dominant[0]["times"]
        for trace in norm[:max_traces]:
            ax3.plot(t, trace, linewidth=0.6, alpha=0.4)
        if len(norm) >= 3:
            ax3.plot(t, np.median(norm, axis=0), "k-", linewidth=2,
                     label="median")
            ax3.fill_between(t, np.percentile(norm, 25, axis=0),
                             np.percentile(norm, 75, axis=0),
                             color="gray", alpha=0.3, label="25-75 pct")
            ax3.legend(fontsize=8)
        ax3.set_title(f"Normalized max amplitude ({len(norm)} runs)")
    ax3.set_xlabel("$t$")
    ax3.set_ylabel(r"$\max|u(t)|/\max|u(0)|$")
    ax3.grid(True, linestyle=":", alpha=0.3)

    # mean energy components over the dominant group (:392-478)
    if by_len:
        comp_rows = [r for r in dominant
                     if np.isfinite(r["gradient_energies"]).all()
                     and np.isfinite(r["potential_energies"]).all()]
        if len(comp_rows) >= 3:
            t = comp_rows[0]["times"]
            for label, key, color in (
                    (r"$\langle E_{kin}\rangle$", "kinetic_energies", "b"),
                    (r"$\langle E_{grad}\rangle$", "gradient_energies", "g"),
                    (r"$\langle E_{pot}\rangle$", "potential_energies", "r")):
                stack = np.array([r[key] for r in comp_rows])
                if not np.any(stack):
                    continue
                ax4.plot(t, stack.mean(axis=0), color + "-", linewidth=2,
                         label=label)
                for trace in stack[:5]:
                    ax4.plot(t, trace, color + "-", linewidth=0.6, alpha=0.2)
            total = np.array([r["energies"] for r in comp_rows])
            ax4.plot(t, total.mean(axis=0), "k--", linewidth=1.5,
                     label=r"$\langle E_{tot}\rangle$")
            ax4.set_yscale("symlog", linthresh=10)
            ax4.legend(fontsize=8)
        ax4.set_title(f"Energy components ({len(comp_rows)} runs)")
    ax4.set_xlabel("$t$")
    ax4.set_ylabel("$E$")
    ax4.grid(True, which="both", linestyle=":", alpha=0.3)

    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def _select_cases(rows):
    """best / median / worst time-integrated conservation + most explosive
    (plot_case_snapshots selection, ensemble_processing.py:952-1010)."""
    scored = []
    for r in rows:
        if r.get("has_nan") or "energy_conservation" not in r:
            continue
        t, cons = r["times"], r["energy_conservation"]
        if len(t) < 2 or not np.isfinite(cons).all():
            continue
        metric = np.trapezoid(cons, t) / t[-1]
        de = np.diff(r["energies"]) / np.diff(t)
        e0 = r["energies"][0]
        expl = np.max(np.abs(de)) / abs(e0) if e0 != 0 else np.nan
        scored.append((metric, expl, r["filename"]))
    if not scored:
        return []
    scored.sort()
    med = min(scored, key=lambda s: abs(s[0] - scored[len(scored) // 2][0]))
    cases = [("best", scored[0][2]), ("median", med[2]),
             ("worst", scored[-1][2])]
    finite_expl = [s for s in scored if np.isfinite(s[1])]
    if finite_expl:
        cases.append(("explosive", max(finite_expl, key=lambda s: s[1])[2]))
    seen, out = set(), []
    for label, fn in cases:
        if fn not in seen:
            seen.add(fn)
            out.append((label, fn))
    return out


def case_snapshots(rows, path, group_key, n_frames=3):
    """Representative-run snapshot grid (plot_case_snapshots :939-1092).
    3D runs are shown as their mid-z slice."""
    plt = _plt()
    h5py = h5py_or_raise()
    cases = _select_cases(rows)
    if not cases:
        return None
    fig, axes = plt.subplots(len(cases), n_frames,
                             figsize=(3.1 * n_frames, 3.0 * len(cases)),
                             squeeze=False)
    for ax_row, (label, fn) in zip(axes, cases):
        try:
            with h5py.File(fn, "r") as f:
                u = f["u"]
                S = u.shape[0]
                idx = np.linspace(0, S - 1, n_frames).round().astype(int)
                frames = [u[i] for i in idx]
        except OSError:
            for ax in ax_row:
                ax.axis("off")
            continue
        frames = [np.abs(fr) if np.iscomplexobj(fr) else fr
                  for fr in frames]
        if frames[0].ndim == 3:
            frames = [fr[fr.shape[0] // 2] for fr in frames]
        vmin = min(fr.min() for fr in frames)
        vmax = max(fr.max() for fr in frames)
        for ax, fr, i in zip(ax_row, frames, idx):
            im = ax.imshow(fr, origin="lower", cmap="viridis",
                           vmin=vmin, vmax=vmax)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_title(f"snap {i}/{S - 1}", fontsize=8)
        ax_row[0].set_ylabel(f"{label}\n{Path(fn).stem[:18]}", fontsize=7)
        fig.colorbar(im, ax=list(ax_row), shrink=0.8)
    dims, ptype = group_key
    fig.suptitle(f"Representative runs ({dims}D {ptype})")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def field_info(rows, path, group_key):
    """m/c field statistics vs conservation (plot_field_info :746-934):
    field mean/std histograms and drift-vs-heterogeneity scatter."""
    plt = _plt()
    h5py = h5py_or_raise()
    stats = []
    for r in rows:
        try:
            with h5py.File(r["filename"], "r") as f:
                c = next((f[loc][()] for loc in
                          ("anisotropy/c", "focusing/c", "c") if loc in f),
                         None)
                m = next((f[loc][()] for loc in ("focusing/m", "m")
                          if loc in f), None)
        except OSError:
            continue
        row = {"dev": r.get("max_energy_deviation", np.nan)}
        if m is not None:
            row.update(m_mean=float(np.mean(m)), m_std=float(np.std(m)))
        if c is not None:
            row.update(c_mean=float(np.mean(c)), c_std=float(np.std(c)))
        stats.append(row)
    if len(stats) < 3:
        return None
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for ax, key, label in ((axes[0], "m_mean", r"$\bar m$"),
                           (axes[1], "c_std", r"$\sigma(c)$")):
        vals = [s[key] for s in stats if key in s]
        if vals:
            ax.hist(vals, bins=min(20, max(5, len(vals))),
                    color="steelblue", edgecolor="k", linewidth=0.4)
        ax.set_xlabel(label)
        ax.set_ylabel("count")
        ax.grid(True, linestyle=":", alpha=0.3)
    pairs = [(s.get("m_std", s.get("c_std", 0.0)), s["dev"])
             for s in stats if np.isfinite(s["dev"])]
    if pairs:
        axes[2].scatter([p[0] for p in pairs], [p[1] for p in pairs],
                        s=18, alpha=0.7)
        axes[2].set_yscale("log")
    axes[2].set_xlabel("field heterogeneity (std)")
    axes[2].set_ylabel(r"$\max_t |E-E_0|/|E_0|$")
    axes[2].grid(True, which="both", linestyle=":", alpha=0.3)
    dims, ptype = group_key
    fig.suptitle(f"Field statistics ({dims}D {ptype})")
    fig.tight_layout(rect=[0.02, 0.02, 0.98, 0.93])
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def ensemble_dashboard(base_dir, out_dir, max_workers=8):
    """Process every archive under base_dir and emit the per-group figure
    set + collective stats JSON. Returns {group: {artifact: path}}."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = ens.find_h5_files(base_dir)
    results = ens.process_files(files, return_timeseries=True,
                                max_workers=max_workers)
    artifacts = {}
    for key, rows in _group(results).items():
        dims, ptype = key
        tag = f"{dims}D_{ptype}"
        group_art = {}
        p = energy_dashboard(rows, out / f"energy_plots_{tag}.png", key)
        group_art["energy_plots"] = str(p)
        p = case_snapshots(rows, out / f"case_snapshots_{tag}.png", key)
        if p:
            group_art["case_snapshots"] = str(p)
        p = field_info(rows, out / f"field_info_{tag}.png", key)
        if p:
            group_art["field_info"] = str(p)
        artifacts[tag] = group_art

    stats = ens.collective_stats(results)
    stats_path = out / "collective_stats.json"
    with open(stats_path, "w") as f:
        json.dump({f"{d}D_{t}": {k: (v if not isinstance(v, np.floating)
                                     else float(v))
                                 for k, v in row.items() if k != "files"}
                   for (d, t), row in stats.items()}, f, indent=2,
                  default=float)
    artifacts["collective_stats"] = str(stats_path)
    return artifacts


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Ensemble dashboards over a directory of HDF5 archives "
                    "(process_h5/ensemble_processing.py equivalent).")
    p.add_argument("base_dir", help="directory tree of .h5 archives")
    p.add_argument("--output-dir", default=None,
                   help="default: <base_dir>/dashboards")
    p.add_argument("--max-workers", type=int, default=8)
    args = p.parse_args(argv)
    out = args.output_dir or str(Path(args.base_dir) / "dashboards")
    artifacts = ensemble_dashboard(args.base_dir, out,
                                   max_workers=args.max_workers)
    print(json.dumps(artifacts, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
