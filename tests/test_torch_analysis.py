"""The port's analysis diagnostics against the JAX package's.

nlsolvers_tpu_torch/analysis/{energy, conservation, spectral, structure,
classify, isosurface, ensemble, global_runs, animate} are numpy copies of
nlsolvers_tpu/analysis/, so every comparison here is EQUAL arrays (NaN
where NaN) on the same seeded numpy inputs, not a tolerance:

* energy: every problem type's energy_terms on a snapshot stack, the mass,
  the interior gradient norm with c(x), both Hamiltonians;
* conservation: log10_rel_error, the NLSE and real-wave trajectory metrics,
  with and without a non-finite snapshot;
* spectral and structure: every function, 2D stacks;
* classify features for every system, marching_tetrahedra on a 3D field;
* ensemble (process_files, collective_stats, find_nonfinite_runs) and
  global_runs.analyze_all_runs over HDF5 archives written by the port's
  pipeline/io_hdf5.save_run, the same files read by both packages;
* the animate writers, the classification and global dashboards write
  non-empty files, and so does the dashboards CLI over the archives;
* `import nlsolvers_tpu_torch.analysis` (and study, compare, utils.
  profiling) in a process where h5py and matplotlib cannot be imported;
  ensemble.extract_metadata then raises io_hdf5's RuntimeError.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nlsolvers_tpu.analysis import classify as jclassify
from nlsolvers_tpu.analysis import conservation as jcons
from nlsolvers_tpu.analysis import energy as jenergy
from nlsolvers_tpu.analysis import ensemble as jensemble
from nlsolvers_tpu.analysis import global_runs as jglobal
from nlsolvers_tpu.analysis import isosurface as jiso
from nlsolvers_tpu.analysis import spectral as jspectral
from nlsolvers_tpu.analysis import structure as jstructure
from nlsolvers_tpu_torch.analysis import animate as tanimate
from nlsolvers_tpu_torch.analysis import classify as tclassify
from nlsolvers_tpu_torch.analysis import conservation as tcons
from nlsolvers_tpu_torch.analysis import energy as tenergy
from nlsolvers_tpu_torch.analysis import ensemble as tensemble
from nlsolvers_tpu_torch.analysis import global_runs as tglobal
from nlsolvers_tpu_torch.analysis import isosurface as tiso
from nlsolvers_tpu_torch.analysis import spectral as tspectral
from nlsolvers_tpu_torch.analysis import structure as tstructure
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio
from test_torch_pipeline import _equal

torch.set_num_threads(1)

N, LX, S = 32, 5.0, 5
DXY = (2 * LX / (N - 1),) * 2
ROOT = Path(__file__).resolve().parent.parent


def _same(jfn, tfn, *args, **kwargs):
    """jfn and tfn on the same arguments give equal results."""
    want = jfn(*args, **kwargs)
    got = tfn(*args, **kwargs)
    _equal(got, want)
    return got


def _stack(seed, complex_=False, S=S, n=N):
    rng = np.random.default_rng(seed)
    x = np.linspace(-LX, LX, n)
    base = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4)
    u = np.stack([(1 + 0.05 * t) * base + 0.01 * rng.standard_normal((n, n))
                  for t in range(S)])
    if complex_:
        u = u + 0.1j * rng.standard_normal(u.shape)
    return u


@pytest.mark.parametrize("ptype", ["klein_gordon", "cubic", "sine_gordon",
                                   "phi4", "unknown"])
def test_energy_terms_equal(ptype):
    u = _stack(0, complex_=ptype == "cubic")
    v = None if ptype == "cubic" else _stack(1)
    _same(jenergy.energy_terms, tenergy.energy_terms, u, v, DXY, ptype)
    _same(jenergy.energy_terms, tenergy.energy_terms, u[2],
          None if v is None else v[2], DXY, ptype)


def test_energy_functionals_equal():
    u, z, v = _stack(2), _stack(3, complex_=True), _stack(4)
    c = 1.0 + 0.3 * np.random.default_rng(5).random((N, N))
    m = 0.5 + np.random.default_rng(6).random((N, N))
    _same(jenergy.mass_nlse, tenergy.mass_nlse, z, DXY)
    _same(jenergy.gradient_sq_norm, tenergy.gradient_sq_norm, u, DXY)
    _same(jenergy.gradient_sq_norm, tenergy.gradient_sq_norm, u, DXY, c=c)
    _same(jenergy.hamiltonian_nlse, tenergy.hamiltonian_nlse, z, DXY,
          m_eff=0.7)
    _same(jenergy.hamiltonian_kge_u_cubed, tenergy.hamiltonian_kge_u_cubed,
          u, v, DXY, m=m, c=c)
    u3 = np.random.default_rng(7).standard_normal((3, 8, 9, 10))
    _same(jenergy.energy_terms, tenergy.energy_terms, u3, u3 ** 2,
          (0.1, 0.2, 0.3), "sine_gordon")


def test_log10_rel_error_equal():
    series = np.array([1.0, 1.0, 1.0 + 1e-18, 2.0, np.nan, 1.0 + 1e-9])
    for ref in (1.0, 0.0, np.nan, 1e-16):
        _same(jcons.log10_rel_error, tcons.log10_rel_error, series, ref)


@pytest.mark.parametrize("bad_at", [None, 3, 0])
def test_trajectory_metrics_equal(bad_at):
    z, u, v = _stack(8, complex_=True), _stack(9), _stack(10)
    m = 0.5 + np.random.default_rng(11).random((N, N))
    c = 1.0 + 0.3 * np.random.default_rng(12).random((N, N))
    if bad_at is not None:
        z[bad_at, 1, 2] = np.nan
        v[bad_at, 3, 4] = np.inf
    _same(jcons.analyze_nlse_trajectory, tcons.analyze_nlse_trajectory, z,
          DXY, 0.4)
    _same(jcons.analyze_realwave_trajectory,
          tcons.analyze_realwave_trajectory, u, v, DXY, 0.4, m=m, c=c)


def test_spectral_equal():
    rng = np.random.default_rng(13)
    z = _stack(14, complex_=True)
    _same(jspectral.modal_energy_spectrum, tspectral.modal_energy_spectrum,
          z)
    _same(jspectral.modal_energy_spectrum, tspectral.modal_energy_spectrum,
          z.real, n_bins=7)
    _same(jspectral.modal_decomposition_entropy,
          tspectral.modal_decomposition_entropy, z, *DXY, n_dominant=4)
    _same(jspectral.spectral_dispersion, tspectral.spectral_dispersion, z,
          *DXY)
    _same(jspectral.spatiotemporal_mutual_information,
          tspectral.spatiotemporal_mutual_information,
          rng.standard_normal((6, N, N)), n_regions=2)


def test_structure_equal():
    u, v = _stack(15), _stack(16)
    _same(jstructure.modal_energy_grid, tstructure.modal_energy_grid, u,
          n_modes=8)
    _same(jstructure.structure_similarity, tstructure.structure_similarity,
          u)
    _same(jstructure.structure_similarity, tstructure.structure_similarity,
          np.abs(_stack(17, complex_=True)), reference_frame=u[-1])
    _same(jstructure.observed_dispersion, tstructure.observed_dispersion,
          _stack(18, complex_=True), DXY[0], 1e-3, n_bins=12)
    _same(jstructure.local_conservation, tstructure.local_conservation, u,
          v, 1e-2)
    _same(jstructure.sublevel_persistence, tstructure.sublevel_persistence,
          u[1][:12, :12])


@pytest.mark.parametrize("system", sorted(jclassify.POTENTIALS))
def test_classify_features_equal(system):
    x = np.linspace(-LX, LX, N)
    kink = 4 * np.arctan(np.exp(x[:, None] + 0.0 * x[None, :]))
    rng = np.random.default_rng(19)
    u = np.stack([kink + 0.01 * t + 0.01 * rng.standard_normal((N, N))
                  for t in range(4)])
    v = 0.1 * rng.standard_normal((4, N, N))
    _same(jclassify.trajectory_features, tclassify.trajectory_features, u,
          DXY[0], DXY[1], 0.1, system, v=v)
    with pytest.raises(ValueError):
        tclassify.trajectory_features(u, DXY[0], DXY[1], 0.1, "bogus")


def test_marching_tetrahedra_equal():
    _equal(tiso._CORNERS, jiso._CORNERS)
    _equal(tiso._TETS, jiso._TETS)
    x = np.linspace(-1, 1, 14)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    field = np.sqrt(X ** 2 + 1.3 * Y ** 2 + Z ** 2)
    dx = x[1] - x[0]
    verts, tris = _same(jiso.marching_tetrahedra, tiso.marching_tetrahedra,
                        field, 0.6, spacing=(dx,) * 3, origin=(-1.0,) * 3)
    assert len(tris) > 100
    _same(jiso.marching_tetrahedra, tiso.marching_tetrahedra,
          np.zeros((1, 4, 4)), 0.5)


def _archives(tmp_path):
    """Archives written by the port's save_run: four 2D sine-Gordon runs
    with v, m and c, two 2D cubic runs (one diverged), one 3D
    Klein-Gordon run; a non-archive .h5 file that neither can read."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(20)
    x = np.linspace(-LX, LX, N)
    kink = 4 * np.arctan(np.exp(x[:, None] + 0.0 * x[None, :]))
    common = dict(phenomenon="test", phenomenon_params={"a": 1}, T=1.0,
                  nt=40, num_snapshots=S)
    for i in range(4):
        u = np.stack([kink + 0.02 * np.sin(0.3 * s + i) for s in range(S)])
        v = 0.1 * rng.standard_normal((S, N, N))
        tio.save_run(tmp_path / f"run_sg{i}.h5", problem_type="sine_gordon",
                     run_id=f"sg{i}", run_index=i, shape=(N, N),
                     extents=(LX, LX), u0=u[0], u=u, v0=v[0], v=v,
                     m=np.ones((N, N)),
                     c=1.0 + 0.1 * rng.standard_normal((N, N)), **common)
    for i, bad in enumerate((False, True)):
        z = _stack(21 + i, complex_=True)
        if bad:
            z[2:] = np.nan
        tio.save_run(tmp_path / f"run_c{i}.h5", problem_type="cubic",
                     run_id=f"c{i}", run_index=10 + i, shape=(N, N),
                     extents=(LX, LX), u0=z[0], u=z, **common)
    u3 = rng.standard_normal((3, 8, 8, 8))
    tio.save_run(tmp_path / "kg3d.h5", problem_type="klein_gordon",
                 run_id="kg", run_index=20, shape=(8, 8, 8),
                 extents=(LX, LX, LX), u0=u3[0], u=u3, v0=u3[0], v=u3 * 0.5,
                 **dict(common, num_snapshots=3))
    (tmp_path / "broken.h5").write_bytes(b"not an archive")
    return tmp_path


def test_ensemble_equal_over_port_archives(tmp_path):
    base = _archives(tmp_path)
    files = _same(jensemble.find_h5_files, tensemble.find_h5_files, base)
    assert len(files) == 8
    for f in files:
        _same(jensemble.extract_metadata, tensemble.extract_metadata, f)
    for ts in (False, True):
        got = _same(jensemble.process_files, tensemble.process_files, files,
                    return_timeseries=ts, max_workers=2)
        assert len(got) == 7          # broken.h5 dropped by both
    stats = _same(jensemble.collective_stats, tensemble.collective_stats,
                  got)
    assert stats[(2, "sine_gordon")]["count"] == 4
    assert stats[(2, "cubic")]["nan_count"] == 1
    flagged = _same(jensemble.find_nonfinite_runs,
                    tensemble.find_nonfinite_runs, base)
    assert sorted(Path(p).name for p in flagged) == ["broken.h5",
                                                     "run_c1.h5"]


def test_global_runs_equal_over_port_archives(tmp_path):
    base = _archives(tmp_path)
    (base / "broken.h5").unlink()
    for system in ("sine_gordon", "klein_gordon", "phi4"):
        metrics = _same(jglobal.analyze_all_runs, tglobal.analyze_all_runs,
                        base, system, pattern="run_sg*.h5")
        assert len(metrics) == 4
    tglobal.global_dashboard(metrics, tmp_path / "global.png")
    assert (tmp_path / "global.png").stat().st_size > 0


def test_dashboards_cli(tmp_path, capsys):
    from nlsolvers_tpu_torch.analysis import dashboards

    base = _archives(tmp_path / "runs")
    (base / "broken.h5").unlink()
    assert dashboards.main([str(base), "--max-workers", "2"]) == 0
    out = base / "dashboards"
    artifacts = json.loads(capsys.readouterr().out)
    assert sorted(artifacts) == ["2D_cubic", "2D_sine_gordon",
                                 "3D_klein_gordon", "collective_stats"]
    for group in ("2D_cubic", "2D_sine_gordon"):
        for path in artifacts[group].values():
            assert (out / Path(path).name).stat().st_size > 0, path
    with open(out / "collective_stats.json") as f:
        assert json.load(f)["2D_sine_gordon"]["count"] == 4


def test_animation_and_dashboard_writers(tmp_path):
    rng = np.random.default_rng(22)
    traj2d = rng.standard_normal((3, 16, 16))
    tanimate.snapshot_grid(traj2d, tmp_path / "grid.png", n_frames=3)
    tanimate.animate_2d(traj2d + 1j * traj2d, str(tmp_path / "t.gif"),
                        fps=2)
    traj3d = rng.standard_normal((2, 8, 8, 8))
    tanimate.animate_3d_slices(traj3d, str(tmp_path / "t3.gif"), fps=2)
    x = np.linspace(-1, 1, 10)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    blob = np.asarray([np.exp(-(X ** 2 + Y ** 2 + Z ** 2) / (0.3 + 0.2 * t))
                       for t in range(2)])
    tanimate.animate_3d_isosurface(blob, str(tmp_path / "iso.gif"), fps=2)
    u = np.stack([_stack(23)[0] + 0.01 * t for t in range(4)])
    f = tclassify.classification_dashboard(
        u, DXY[0], DXY[1], 0.1, "sine_gordon", tmp_path / "dash.png",
        v=0.1 * u)
    assert f["symmetry"] <= 1.0
    for name in ("grid.png", "t.gif", "t3.gif", "iso.gif", "dash.png"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_imports_without_h5py_and_matplotlib(tmp_path):
    """The analysis package, study, compare and utils.profiling import in a
    process where h5py and matplotlib cannot be imported; reading an
    archive then raises io_hdf5's RuntimeError, which names the npy
    format."""
    code = f"""
import sys
sys.modules["h5py"] = sys.modules["matplotlib"] = None
import nlsolvers_tpu_torch.analysis as analysis
from nlsolvers_tpu_torch.analysis import compare, study, dashboards
from nlsolvers_tpu_torch.utils import profiling
assert analysis.study is study and analysis.dashboards is dashboards
assert "jax" not in sys.modules and "nlsolvers_tpu" not in sys.modules
from nlsolvers_tpu_torch.analysis import ensemble
try:
    ensemble.extract_metadata({str(tmp_path / "x.h5")!r})
except RuntimeError as e:
    assert "npy" in str(e), e
    print("raised")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["raised"]
