"""Ensemble dataset sweeps over HDF5 archives (process_h5 port, MPI-free).

The reference scatters files over mpi4py ranks
(process_h5/ensemble_processing.py:1239-1276); datasets here are written by
one process group and analyzed with a thread pool — h5py releases the GIL
during reads and the per-file work is numpy, so threads suffice and nothing
needs a launcher.

Also folds in the NaN sweep (process_h5/find_nans.py:11-54).

The port's copy of nlsolvers_tpu/analysis/ensemble.py. h5py is imported
where an archive is opened, through pipeline/io_hdf5.h5py_or_raise, so that
the module imports without it; without h5py those functions raise its
RuntimeError.
"""

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from nlsolvers_tpu_torch.analysis import energy as en
from nlsolvers_tpu_torch.pipeline.io_hdf5 import h5py_or_raise

__all__ = ["find_h5_files", "extract_metadata", "analyze_file_energy",
           "process_files", "collective_stats", "find_nonfinite_runs"]


def find_h5_files(base_dir, pattern="**/*.h5"):
    return sorted(set(Path(base_dir).glob(pattern)))


def extract_metadata(h5_file):
    """Flattened metadata/grid/time attrs + dims (ensemble_processing.py:19)."""
    h5py = h5py_or_raise()
    try:
        with h5py.File(h5_file, "r") as f:
            meta = dict(f["metadata"].attrs) if "metadata" in f else {}
            for grp in ("grid", "time"):
                if grp in f:
                    meta.update(dict(f[grp].attrs))
            meta["filename"] = str(h5_file)
            if "u" in f:
                # snapshot stack: (S, ny, nx) -> 2D, (S, nz, ny, nx) -> 3D
                meta["dims"] = {3: 2, 4: 3}.get(f["u"].ndim, -1)
            else:
                meta["dims"] = 0
            return meta
    except OSError:
        return None


def _read_fields(f):
    c = next((f[loc][()] for loc in ("anisotropy/c", "focusing/c", "c")
              if loc in f), None)
    m = next((f[loc][()] for loc in ("focusing/m", "m") if loc in f), None)
    return c, m


def analyze_file_energy(h5_file, return_timeseries=False):
    """Per-file energy decomposition + conservation summary
    (ensemble_processing.py:91-215). Returns None on unreadable files."""
    h5py = h5py_or_raise()
    try:
        with h5py.File(h5_file, "r") as f:
            meta = extract_metadata(h5_file)
            problem_type = meta.get("problem_type", "unknown")
            u = f["u"][()]
            v = f["v"][()] if "v" in f else None
            c, m = _read_fields(f)
            dim = meta["dims"]
            if dim not in (2, 3):
                return None
            spacings = []
            for n_key, L_key in (("nx", "Lx"), ("ny", "Ly"), ("nz", "Lz")):
                if n_key in meta and meta[n_key] > 1:
                    spacings.append(2 * meta[L_key] / (meta[n_key] - 1))
            spacings = tuple(spacings[:dim])
            T = meta.get("T", 1.0)
            S = u.shape[0]
    except (OSError, KeyError):
        return None

    total, kin, grad, pot = en.energy_terms(u, v, spacings, problem_type)
    total = np.atleast_1d(total)
    amps = np.max(np.abs(u.reshape(S, -1)), axis=1)
    has_nan = bool(np.isnan(u).any() or np.isnan(total).any())

    e0 = total[0]
    if e0 != 0 and np.isfinite(e0):
        conservation = np.abs((total - e0) / e0)
        ratios = np.where(np.isfinite(total), total / e0, np.nan)
    else:
        conservation = np.abs(total - e0)
        ratios = np.full(S, np.nan)
        has_nan = True

    all_nan = np.all(np.isnan(conservation))
    result = {
        "filename": str(h5_file),
        "problem_type": problem_type,
        "dims": dim,
        "initial_energy": total[0],
        "final_energy": total[-1],
        "max_energy_deviation": np.nan if all_nan else np.nanmax(conservation),
        "mean_energy_deviation": (np.nan if all_nan
                                  else np.nanmean(conservation)),
        "initial_amplitude": amps[0],
        "final_amplitude": amps[-1],
        "amplitude_ratio": amps[-1] / amps[0] if amps[0] > 0 else np.nan,
        "T": T,
        "has_nan": has_nan,
        "max_energy_ratio": (np.nan if np.all(np.isnan(ratios))
                             else np.nanmax(ratios)),
        "num_snapshots": S,
    }
    if return_timeseries:
        result.update(times=np.linspace(0, T, S), energies=total,
                      kinetic_energies=np.atleast_1d(kin),
                      gradient_energies=np.atleast_1d(grad),
                      potential_energies=np.atleast_1d(pot),
                      max_amplitudes=amps, energy_conservation=conservation)
    return result


def process_files(files, return_timeseries=False, max_workers=8):
    """Analyze many archives concurrently; unreadable files are dropped."""
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = pool.map(
            lambda p: analyze_file_energy(p, return_timeseries), files)
    return [r for r in results if r is not None]


def collective_stats(results):
    """Group per-file results by (dims, problem_type) and aggregate the
    ensemble statistics the reference tabulates
    (generate_collective_stats, ensemble_processing.py:232-360)."""
    groups = defaultdict(list)
    for r in results:
        groups[(r["dims"], r["problem_type"])].append(r)

    out = {}
    for key, rows in groups.items():
        devs = np.array([r["max_energy_deviation"] for r in rows])
        amps = np.array([r["amplitude_ratio"] for r in rows])
        out[key] = {
            "count": len(rows),
            "nan_count": sum(r["has_nan"] for r in rows),
            "nan_fraction": np.mean([r["has_nan"] for r in rows]),
            "max_energy_deviation_mean": np.nanmean(devs),
            "max_energy_deviation_median": np.nanmedian(devs),
            "max_energy_deviation_worst": np.nanmax(devs)
            if not np.all(np.isnan(devs)) else np.nan,
            "amplitude_ratio_mean": np.nanmean(amps),
            "files": [r["filename"] for r in rows],
        }
    return out


def find_nonfinite_runs(base_dir, datasets=("u", "v")):
    """Walk every archive under base_dir and flag non-finite trajectories
    (find_nans.py:11-54). Returns {path: [dataset names with NaN/Inf]}."""
    h5py = h5py_or_raise()
    flagged = {}
    for path in find_h5_files(base_dir):
        bad = []
        try:
            with h5py.File(path, "r") as f:
                for name in datasets:
                    if name in f and not np.isfinite(f[name][()]).all():
                        bad.append(name)
        except OSError:
            bad.append("<unreadable>")
        if bad:
            flagged[str(path)] = bad
    return flagged
