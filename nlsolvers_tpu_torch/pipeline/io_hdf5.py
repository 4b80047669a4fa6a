"""HDF5 run archives, schema-compatible with the reference datasets.

Layout parity (finalized_scripts/complex_launcher_2d.py:196-240 and
real_launcher_2d.py:201-243) so downstream tooling written for reference
datasets (process_h5/, classify_trajectory.py, animate_hdf.py) reads these
files unchanged:

  metadata/            attrs: problem_type, boundary_condition, run_id,
                       run_index, timestamp, elapsed_time, phenomenon,
                       phenomenon_<param>...
  grid/                attrs: nx, ny [, nz], Lx, Ly [, Lz]
  time/                attrs: T, nt, num_snapshots
  initial_condition/   u0 [, v0]
  focusing/            attrs: type [, mean, std, scale]; datasets m [, c*]
  c                    anisotropy field (complex runs keep c at root: :233)
  u [, v]              trajectory [velocity] snapshot stacks
  X, Y [, Z]           coordinate meshes

(*) the real-wave reference stores c inside focusing/ (real_launcher_2d.py:239)
while the complex one stores it at root — both kept for parity.

Fix relative to the reference: complex_launcher_2d.py:138 saves m into the
c-file (c never hits disk) and complex_launcher_3d.py:224-227 writes ny/Ly
into the nz/Lz attrs; here c is c and nz is nz.

h5py is imported by the functions that use it, so that the pipeline imports
without it; where it is missing they raise, and the npy archive format
(datagen's archive_format="npy") needs no h5py.
"""

import datetime

import numpy as np

__all__ = ["save_run", "load_run", "h5py_or_raise"]


def h5py_or_raise():
    """The h5py module; a RuntimeError naming the npy format without it."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "HDF5 archives need h5py, which is not installed; use the npy "
            "archive format (--format npy, archive_format='npy')") from e
    return h5py


def _grid_meshes(shape, extents):
    axes = [np.linspace(-L, L, n) for n, L in zip(shape, extents)]
    return np.meshgrid(*axes, indexing="ij")


def save_run(path, *, problem_type, run_id, run_index, phenomenon,
             phenomenon_params, shape, extents, T, nt, num_snapshots,
             u0, u, v0=None, v=None, m=None, c=None, m_type="constant",
             m_attrs=None, elapsed_time=0.0, boundary_condition="noflux",
             extra_meta=None, scalar_series=None):
    """Write one trajectory archive. `shape`/`extents` are grid (ny, nx[, nz]
    ordering consistent with the arrays); complex trajectories are stored as
    native complex datasets (host-side numpy).

    scalar_series: optional {name: (num_snapshots,) array} recorded during
    generation (e.g. on-device mass/energy, engine.make_*_trajectory_fn with
    record_energy=True) — stored under the `energy/` group."""
    h5py = h5py_or_raise()
    dim = len(shape)
    is_real = v is not None
    with h5py.File(path, "w") as f:
        meta = f.create_group("metadata")
        meta.attrs["problem_type"] = problem_type
        meta.attrs["boundary_condition"] = boundary_condition
        meta.attrs["run_id"] = run_id
        meta.attrs["run_index"] = run_index
        meta.attrs["timestamp"] = str(datetime.datetime.now())
        meta.attrs["elapsed_time"] = elapsed_time
        meta.attrs["phenomenon"] = phenomenon
        for key, value in (phenomenon_params or {}).items():
            meta.attrs[f"phenomenon_{key}"] = str(value)
        for key, value in (extra_meta or {}).items():
            meta.attrs[key] = value

        grid = f.create_group("grid")
        names = ["nx", "ny", "nz"][:dim]
        lens = ["Lx", "Ly", "Lz"][:dim]
        for name, n in zip(names, shape):
            grid.attrs[name] = int(n)
        for name, L in zip(lens, extents):
            grid.attrs[name] = float(L)

        time_grp = f.create_group("time")
        time_grp.attrs["T"] = float(T)
        time_grp.attrs["nt"] = int(nt)
        time_grp.attrs["num_snapshots"] = int(num_snapshots)

        ic = f.create_group("initial_condition")
        ic.create_dataset("u0", data=np.asarray(u0))
        if v0 is not None:
            ic.create_dataset("v0", data=np.asarray(v0))

        foc = f.create_group("focusing")
        foc.attrs["type"] = m_type
        for key, value in (m_attrs or {}).items():
            foc.attrs[key] = value
        if m is not None:
            foc.create_dataset("m", data=np.asarray(m))
        if c is not None:
            if is_real:
                foc.create_dataset("c", data=np.asarray(c))
            f.create_dataset("c", data=np.asarray(c))

        f.create_dataset("u", data=np.asarray(u))
        if v is not None:
            f.create_dataset("v", data=np.asarray(v))
        if scalar_series:
            eg = f.create_group("energy")
            for name, values in scalar_series.items():
                eg.create_dataset(name, data=np.asarray(values))

        meshes = _grid_meshes(shape, extents)
        for name, mesh in zip(["X", "Y", "Z"], meshes):
            f.create_dataset(name, data=mesh)
    return path


def load_run(path):
    """Read a run archive back into a plain dict (datasets + attr groups)."""
    h5py = h5py_or_raise()
    out = {}
    with h5py.File(path, "r") as f:
        for grp in ("metadata", "grid", "time", "focusing"):
            if grp in f:
                out[grp] = dict(f[grp].attrs)
        for name in ("u", "v", "c", "X", "Y", "Z"):
            if name in f:
                out[name] = f[name][...]
        if "initial_condition" in f:
            for name in f["initial_condition"]:
                out[name] = f["initial_condition"][name][...]
        if "focusing" in f:
            for name in f["focusing"]:
                out[f"focusing/{name}"] = f["focusing"][name][...]
    return out
