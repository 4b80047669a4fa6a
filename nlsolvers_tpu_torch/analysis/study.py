"""Integrator-study deliverables: the figure set + CSV + runner CLI.

This is the artifact layer over analysis/compare.integrator_study — the
in-process equivalent of the reference's study outputs
(finalized_scripts/compare_utils_complex_2d.py:383-920 and the runner CLI
compare_integrators_nlse_2d.py:18-86). One call / one command produces:

  initial_fields_*.png          (plot_initial_fields_nlse, :47-91)
  convergence_mass_*.png        (_plot_convergence, :397-430)
  convergence_hamiltonian_*.png
  work_precision_*.png          (_plot_work_precision, :431-525)
  energy_components_*.png       (_plot_energy_component_evolution, :526-572)
  solution_snapshots_*.png      (_plot_solution_snapshots, :573-650)
  solution_differences_*.png    (_plot_solution_differences, :651-752)
  difference_animation_*.gif    (animated |u_a - u_b| at the finest cell)
  summary_results_*.csv         (execute(), :862-866)

Where the reference shells out to pairs of compiled CUDA drivers and round-
trips .npy files through a temp tree, every cell here is one jit of the same
Problem with a different integrator tag, so there is nothing to clean up and
both integrators share bit-identical inputs by construction.

The port's counterpart of nlsolvers_tpu/analysis/study.py: the cells run
on the port's problems on `device` (the card unless the caller asks for the
CPU) through analysis/compare.py, the figures and the CSV are the same
numpy and matplotlib code. CLI: `python -m
nlsolvers_tpu_torch.analysis.study --output-dir OUT ...` (add `--device
cpu` where there is no card).
"""

import argparse
import csv
import json
from pathlib import Path

import numpy as np
import torch

from nlsolvers_tpu_torch.analysis import animate as anim
from nlsolvers_tpu_torch.analysis import compare
from nlsolvers_tpu_torch.pipeline import fields as field_gen
from nlsolvers_tpu_torch.pipeline.grids import Grid2D
from nlsolvers_tpu_torch.pipeline.samplers import (
    NLSEPhenomenonSampler, RealWaveSampler)

__all__ = ["run_study", "save_summary_csv", "plot_initial_fields",
           "plot_convergence", "plot_work_precision",
           "plot_energy_components", "plot_solution_snapshots",
           "plot_solution_differences", "main"]

SUMMARY_COLUMNS = ("integrator", "nx", "dt", "T_sim", "walltime",
                   "final_mass_log10_rel_error",
                   "final_hamiltonian_log10_rel_error",
                   "max_abs_hamiltonian_rel_error", "simulation_stable")
DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128,
          "float32": torch.float32, "float64": torch.float64}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _final(series):
    series = np.atleast_1d(np.asarray(series, float))
    return series[-1] if series.size else np.nan


def summary_rows(results, T):
    """Flatten integrator_study output into the reference's summary table
    (compare_utils_complex_2d.py:816-826)."""
    rows = []
    for (integrator, nx, dt), r in sorted(results.items()):
        rows.append({
            "integrator": integrator, "nx": nx, "dt": dt, "T_sim": T,
            "walltime": r["walltime"],
            "final_mass_log10_rel_error": _final(r["mass_log10_rel_error"]),
            "final_hamiltonian_log10_rel_error":
                _final(r["hamiltonian_log10_rel_error"]),
            "max_abs_hamiltonian_rel_error":
                r["max_abs_hamiltonian_rel_error"],
            "simulation_stable": bool(r["simulation_stable"]),
        })
    return rows


def save_summary_csv(rows, path):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=SUMMARY_COLUMNS)
        w.writeheader()
        w.writerows(rows)
    return path


def plot_initial_fields(u0, m, c, Lx, path, v0=None, title=""):
    """2x2 panel of the study inputs (plot_initial_fields_nlse, :47-91):
    |u0|^2 / phase for NLSE, u0 / v0 for real-wave, plus c and m."""
    plt = _plt()
    ext = (-Lx, Lx, -Lx, Lx)
    is_complex = np.iscomplexobj(u0)
    panels = [
        (np.abs(u0) ** 2 if is_complex else u0,
         r"$|u_0|^2$" if is_complex else r"$u_0$", "viridis"),
        (np.angle(u0) if is_complex
         else (v0 if v0 is not None else np.zeros_like(u0)),
         r"$\arg u_0$" if is_complex else r"$v_0$",
         "twilight" if is_complex else "viridis"),
        (c if c is not None else np.ones_like(np.abs(u0)),
         r"$c(x,y)$", "cividis"),
        (m if m is not None else np.ones_like(np.abs(u0)),
         r"$m(x,y)$", "cividis"),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(8, 8))
    for ax, (data, label, cmap) in zip(axes.ravel(), panels):
        im = ax.imshow(np.asarray(data, float) if not np.iscomplexobj(data)
                       else np.abs(data), origin="lower", extent=ext,
                       cmap=cmap, aspect="equal")
        ax.set_title(label)
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.suptitle(title or "Study inputs (finest grid)")
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_convergence(rows, metric, ylabel, path, title=""):
    """One column per nx; each shows metric vs dt per integrator
    (_plot_convergence, :397-430)."""
    plt = _plt()
    nxs = sorted({r["nx"] for r in rows})
    names = sorted({r["integrator"] for r in rows})
    fig, axes = plt.subplots(1, len(nxs), figsize=(4 * len(nxs), 4),
                             sharey=True, squeeze=False)
    for ax, nx in zip(axes[0], nxs):
        for name in names:
            pts = sorted((r["dt"], r[metric]) for r in rows
                         if r["nx"] == nx and r["integrator"] == name)
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", label=name)
        ax.set_xscale("log")
        ax.set_xlabel(r"$\Delta t$")
        ax.set_title(f"nx = {nx}")
        ax.grid(True, alpha=0.3)
    axes[0][0].set_ylabel(ylabel)
    axes[0][0].legend()
    fig.suptitle(title)
    fig.tight_layout(rect=[0.02, 0.02, 0.98, 0.93])
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_work_precision(rows, path, metric="max_abs_hamiltonian_rel_error",
                        ylabel=r"$\max_t |(H-H_0)/H_0|$", title=""):
    """Error vs walltime, one trace per (integrator, nx), points along dt
    (_plot_work_precision, :431-525)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    names = sorted({r["integrator"] for r in rows})
    nxs = sorted({r["nx"] for r in rows})
    markers = "osD^vP*X"
    any_pts = False
    for i, name in enumerate(names):
        for j, nx in enumerate(nxs):
            pts = sorted(((r["walltime"], r[metric]) for r in rows
                          if r["integrator"] == name and r["nx"] == nx
                          and np.isfinite(r[metric]) and r[metric] > 0))
            if not pts:
                continue
            any_pts = True
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker=markers[j % len(markers)], linestyle="--",
                    color=f"C{i}", label=f"{name} nx={nx}")
    ax.set_xscale("log")
    if any_pts:   # log axes explode when every cell diverged (all-NaN)
        ax.set_yscale("log")
    ax.set_xlabel("walltime [s]")
    ax.set_ylabel(ylabel)
    ax.grid(True, which="both", alpha=0.3)
    if any_pts:
        ax.legend(fontsize=8)
    fig.suptitle(title or "Work-precision")
    fig.tight_layout(rect=[0.02, 0.02, 0.98, 0.93])
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_energy_components(results, path, nx=None, title=""):
    """Hamiltonian component time series at the finest grid, one row per
    (integrator, dt) run (_plot_energy_component_evolution, :526-572)."""
    plt = _plt()
    if nx is None:
        nx = max(k[1] for k in results)
    cells = sorted((k, r) for k, r in results.items() if k[1] == nx)
    if not cells:
        return None
    fig, axes = plt.subplots(len(cells), 1,
                             figsize=(7, 2.4 * len(cells)),
                             sharex=True, squeeze=False)
    for ax, (key, r) in zip(axes[:, 0], cells):
        t = r["time_points"]
        parts = {k[len("hamiltonian_"):]: v for k, v in r.items()
                 if k.startswith("hamiltonian_")
                 and isinstance(v, np.ndarray) and k != "hamiltonian_total"
                 and not k.endswith("rel_error")}
        for label, series in sorted(parts.items()):
            ax.plot(t, series, label=label)
        ax.plot(t, r["hamiltonian_total"], "k--", label="total")
        ax.set_ylabel("energy")
        ax.set_title(f"{key[0]}  nx={key[1]}  dt={key[2]:g}", fontsize=9)
        ax.grid(True, alpha=0.3)
    axes[0, 0].legend(fontsize=7, ncol=4)
    axes[-1, 0].set_xlabel("t")
    fig.suptitle(title or f"Energy components (nx={nx})")
    fig.tight_layout(rect=[0.02, 0.02, 0.98, 0.95])
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_solution_snapshots(results, path, n_frames=5, title=""):
    """|u| frames at the smallest dt, one row per (integrator, nx) that kept
    its trajectory (_plot_solution_snapshots, :573-650)."""
    plt = _plt()
    rows = sorted((k, r) for k, r in results.items() if "trajectory" in r)
    if not rows:
        return None
    fig, axes = plt.subplots(len(rows), n_frames,
                             figsize=(2.2 * n_frames, 2.4 * len(rows)),
                             squeeze=False)
    for ax_row, (key, r) in zip(axes, rows):
        traj = r["trajectory"]
        data = np.abs(traj) if np.iscomplexobj(traj) else traj
        idx = np.linspace(0, len(data) - 1, n_frames).round().astype(int)
        vmin, vmax = np.nanmin(data), np.nanmax(data)
        for ax, i in zip(ax_row, idx):
            im = ax.imshow(data[i], origin="lower", cmap="viridis",
                           vmin=vmin, vmax=vmax)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_title(f"t={r['time_points'][i]:.3g}", fontsize=8)
        ax_row[0].set_ylabel(f"{key[0]}\nnx={key[1]}", fontsize=8)
        fig.colorbar(im, ax=list(ax_row), shrink=0.8)
    fig.suptitle(title or "Solution snapshots (|u|, smallest dt)")
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_solution_differences(results, integrators, path, title=""):
    """Two panels (_plot_solution_differences, :651-752): relative final-time
    L2 difference between the two integrators across the (nx, dt) matrix,
    plus the |difference| heatmap at the finest kept cell."""
    if len(integrators) < 2:
        return None
    plt = _plt()
    a, b = integrators[:2]
    diffs = compare.pairwise_solution_difference(results, (a, b))
    if not diffs:
        return None
    nxs = sorted({k[0] for k in diffs})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    any_pts = False
    for nx in nxs:
        pts = sorted((dt, v) for (n, dt), v in diffs.items()
                     if n == nx and np.isfinite(v) and v > 0)
        if not pts:
            continue
        any_pts = True
        ax1.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                 label=f"nx={nx}")
    ax1.set_xscale("log")
    if any_pts:   # log axes explode on all-NaN data (diverged cells)
        ax1.set_yscale("log")
    ax1.set_xlabel(r"$\Delta t$")
    ax1.set_ylabel(r"$\|u_A - u_B\|_2 / \|u_A\|_2$ at $t=T$")
    ax1.grid(True, which="both", alpha=0.3)
    if any_pts:
        ax1.legend()

    kept = [(k, r) for k, r in results.items()
            if "trajectory" in r and k[0] == a]
    shown = False
    for key, ra in sorted(kept, key=lambda kr: -kr[0][1]):
        rb = results.get((b, key[1], key[2]))
        if rb is None or "trajectory" not in rb:
            continue
        d = np.abs(ra["trajectory"][-1] - rb["trajectory"][-1])
        im = ax2.imshow(d, origin="lower", cmap="magma")
        ax2.set_title(f"|{a} - {b}| at t=T, nx={key[1]}, dt={key[2]:g}",
                      fontsize=9)
        fig.colorbar(im, ax=ax2, shrink=0.85)
        shown = True
        break
    if not shown:
        ax2.axis("off")
    fig.suptitle(title or f"Solution differences: {a} vs {b}")
    fig.tight_layout(rect=[0.02, 0.02, 0.98, 0.92])
    fig.savefig(path)
    plt.close(fig)
    return path


def difference_animation(results, integrators, out_path, fps=8):
    """Animate |u_A - u_B| over the kept finest-cell trajectories — the
    reference's solution-difference animation deliverable."""
    if len(integrators) < 2:
        return None
    a, b = integrators[:2]
    kept = sorted(((k, r) for k, r in results.items()
                   if k[0] == a and "trajectory" in r),
                  key=lambda kr: -kr[0][1])
    for key, ra in kept:
        rb = results.get((b, key[1], key[2]))
        if rb is not None and "trajectory" in rb:
            diff = np.abs(ra["trajectory"] - rb["trajectory"])
            if not np.isfinite(diff).any():   # both/either run diverged
                continue
            return anim.animate_2d(diff, out_path, fps=fps,
                                   title=f"|{a}-{b}| nx={key[1]}")
    return None


def _study_inputs(family, kind, phenomenon, nx_high, Lx, seed,
                  m_type, c_type, ic_params):
    """Generate the finest-grid IC + fields once (the reference's
    _prepare_high_resolution_inputs, compare_utils_complex_2d.py:196-239)."""
    grid = Grid2D(nx_high, nx_high, Lx)
    rng = np.random.default_rng(seed)
    if family == "nlse":
        sampler = NLSEPhenomenonSampler(nx_high, nx_high, Lx, seed=seed)
        u0 = sampler.generate_sample(phenomenon, system_type=kind,
                                     **ic_params)
        v0 = None
    else:
        sampler = RealWaveSampler(nx_high, nx_high, Lx, seed=seed)
        u0, v0 = sampler.generate_sample(system_type=kind,
                                         phenomenon_type=phenomenon,
                                         **ic_params)
    c = (field_gen.c_field(c_type, grid, rng) if c_type else None)
    m = (field_gen.m_field(m_type, grid, rng, c=c) if m_type else None)
    return np.asarray(u0), (None if v0 is None else np.asarray(v0)), m, c


def run_study(out_dir, family, kind, *, integrators, nx_values, dt_values,
              T, Lx=10.0, phenomenon=None, m_type=None, c_type=None,
              ic_params=None, num_snapshots=25, krylov_m=10, seed=0,
              animate=True, study_id="study", dtype=None, device="cuda"):
    """Run the full (integrator x nx x dt) matrix and write the reference's
    artifact set into out_dir. Returns {artifact name: path}. dtype and
    device go to compare.integrator_study."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if phenomenon is None:
        phenomenon = ("colliding_packets" if family == "nlse"
                      else "kink_solution")
    nx_high = max(nx_values)
    dt_min = min(dt_values)
    u0, v0, m, c = _study_inputs(family, kind, phenomenon, nx_high, Lx,
                                 seed, m_type, c_type, ic_params or {})

    results = compare.integrator_study(
        family, kind, u0, v0_high=v0, m_high=m, c_high=c,
        integrators=integrators, nx_values=nx_values, dt_values=dt_values,
        T=T, Lx=Lx, num_snapshots=num_snapshots, krylov_m=krylov_m,
        dtype=dtype, keep_traj=lambda nx, dt: dt == dt_min, device=device)
    rows = summary_rows(results, T)

    tag = f"{family}_{kind}_{study_id}"
    artifacts = {}

    def add(name, path):
        if path is not None:
            artifacts[name] = str(path)

    add("summary_csv",
        save_summary_csv(rows, out / f"summary_results_{tag}.csv"))
    add("initial_fields",
        plot_initial_fields(u0, m, c, Lx, out / f"initial_fields_{tag}.png",
                            v0=v0, title=f"{kind} / {phenomenon}"))
    add("convergence_mass",
        plot_convergence(rows, "final_mass_log10_rel_error",
                         r"$\log_{10}(|N-N_0|/|N_0|)$",
                         out / f"convergence_mass_{tag}.png",
                         title="Mass conservation error"))
    add("convergence_hamiltonian",
        plot_convergence(rows, "final_hamiltonian_log10_rel_error",
                         r"$\log_{10}(|H-H_0|/|H_0|)$",
                         out / f"convergence_hamiltonian_{tag}.png",
                         title="Hamiltonian conservation error"))
    add("work_precision",
        plot_work_precision(rows, out / f"work_precision_{tag}.png"))
    add("energy_components",
        plot_energy_components(results,
                               out / f"energy_components_{tag}.png"))
    add("solution_snapshots",
        plot_solution_snapshots(results,
                                out / f"solution_snapshots_{tag}.png"))
    add("solution_differences",
        plot_solution_differences(results, list(integrators),
                                  out / f"solution_differences_{tag}.png"))
    if animate and len(integrators) >= 2:
        add("difference_animation",
            difference_animation(results, list(integrators),
                                 out / f"difference_animation_{tag}.gif"))
    with open(out / f"study_config_{tag}.json", "w") as f:
        json.dump({"family": family, "kind": kind,
                   "integrators": list(integrators),
                   "nx_values": list(nx_values),
                   "dt_values": list(dt_values), "T": T, "Lx": Lx,
                   "phenomenon": phenomenon, "m_type": m_type,
                   "c_type": c_type, "num_snapshots": num_snapshots,
                   "krylov_m": krylov_m, "seed": seed}, f, indent=2)
    artifacts["config"] = str(out / f"study_config_{tag}.json")
    return artifacts


def main(argv=None):
    """Runner CLI, mirroring compare_integrators_nlse_2d.py:18-86 — but
    integrators are in-process tags, not executable paths."""
    p = argparse.ArgumentParser(
        description="Integrator comparison study (convergence, "
                    "work-precision, snapshots, differences).")
    p.add_argument("--family", choices=["nlse", "realwave"], default="nlse")
    p.add_argument("--kind", default="cubic",
                   help="nonlinearity tag (cubic, sine_gordon, ...)")
    p.add_argument("--integrators", nargs="+", default=["ss2", "sewi"],
                   help="integrator tags understood by the Problem builders")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--L", type=float, default=10.0)
    p.add_argument("--T", type=float, default=0.8)
    p.add_argument("--nx", type=int, nargs="+", default=[128, 256])
    p.add_argument("--dt", type=float, nargs="+", default=[0.01, 0.005])
    p.add_argument("--phenomenon", default=None,
                   help="IC phenomenon (default: colliding_packets / "
                        "kink_solution)")
    p.add_argument("--ic-params", default="{}",
                   help="JSON dict of phenomenon parameter overrides")
    p.add_argument("--m-type", default=None)
    p.add_argument("--c-type", default=None)
    p.add_argument("--num-snapshots", type=int, default=25)
    p.add_argument("--krylov-m", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-animation", action="store_true")
    p.add_argument("--study-id", default="study")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the cells run: cuda (the card, default) or "
                        "cpu")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="solve dtype; default complex128/float64 (the "
                        "generic Krylov path), complex64/float32 take the "
                        "kernels")
    args = p.parse_args(argv)
    dtype = DTYPES[args.dtype] if args.dtype else None

    artifacts = run_study(
        args.output_dir, args.family, args.kind,
        integrators=args.integrators,
        nx_values=sorted(set(args.nx)), dt_values=sorted(set(args.dt)),
        T=args.T, Lx=args.L, phenomenon=args.phenomenon,
        m_type=args.m_type, c_type=args.c_type,
        ic_params=json.loads(args.ic_params),
        num_snapshots=args.num_snapshots, krylov_m=args.krylov_m,
        seed=args.seed, animate=not args.no_animation,
        study_id=args.study_id, dtype=dtype, device=args.device)
    for name, path in artifacts.items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
