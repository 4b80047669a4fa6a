"""The port's integrator study (analysis/compare.py, analysis/study.py) and
ensemble dashboards against the JAX package's, on the CPU.

* compare.integrator_study at JAX's tests/test_analysis.py point (cubic
  NLSE, SS2 and sEWI, complex128, nx 32 and 16) and a float64 sine-Gordon
  Gautschi / SV study: each cell's final snapshot, mass and Hamiltonian
  series (total, gradient, potential) within rel 1e-10 of JAX's, the
  kinetic series within rel 1e-8 (v = (u - u_past)/dt carries u's rounding
  times |u|/(dt |v|)); pairwise_solution_difference within rel 1e-8;
* one complex64 c(x) SS2 cell at 128^2 (the least width at which JAX's
  planar path takes the grid: nx % 128 == 0) on the planar path, the
  kernels' plain versions here, against JAX's with its Pallas kernels in
  interpret mode: rel-L2 <= 1e-5 on the final snapshot and the mass series,
  the gate of tests/test_torch_aniso2d.py on the same path;
* study.run_study at tests/test_study.py's arguments: the same artifact
  names as JAX's and a CSV equal in every column but walltime (the float
  columns are log10 drifts of series that agree to rounding, so the drifts
  are held within 1e-12 before the log);
* study.main, the real-wave CLI case of tests/test_study.py, with
  --device cpu; --dtype and the default device reach run_study;
* dashboards.ensemble_dashboard on the fake archives of tests/test_study.py
  gives JAX's artifact set and collective stats.
"""

import csv
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.analysis import compare as jcompare
from nlsolvers_tpu.analysis import dashboards as jdash
from nlsolvers_tpu.analysis import study as jstudy
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.analysis import compare as tcompare
from nlsolvers_tpu_torch.analysis import dashboards as tdash
from nlsolvers_tpu_torch.analysis import study as tstudy
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops.cuda import kick as tkick
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio

torch.set_num_threads(1)

N, LX = 32, 5.0
SERIES = ("mass", "hamiltonian_total", "hamiltonian_gradient",
          "hamiltonian_potential")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cells_close(got, want, tol, series=SERIES):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g["simulation_stable"] and w["simulation_stable"], key
        for k in ("nx", "dt", "nt", "integrator"):
            assert g[k] == w[k], (key, k)
        np.testing.assert_array_equal(g["time_points"], w["time_points"])
        assert g["final_snapshot"].dtype == w["final_snapshot"].dtype, key
        assert _rel(g["final_snapshot"], w["final_snapshot"]) <= tol, key
        for name in series:
            assert np.max(np.abs(g[name] - w[name])
                          / np.abs(w[name])) <= tol, (key, name)
        assert g["walltime"] > 0


def _diffs_close(got, want, pair):
    dg = tcompare.pairwise_solution_difference(got, pair)
    dw = jcompare.pairwise_solution_difference(want, pair)
    assert sorted(dg) == sorted(dw) and dw
    for k in dw:
        assert np.isfinite(dg[k])
        assert abs(dg[k] - dw[k]) <= 1e-8 * abs(dw[k]), k


def test_integrator_study_nlse_matches_jax():
    """JAX's test_integrator_study_nlse point, complex128."""
    x = np.linspace(-LX, LX, N)
    u0 = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 2).astype(complex)
    kw = dict(integrators=("ss2", "sewi"), nx_values=[N, N // 2],
              dt_values=[1e-3], T=0.02, Lx=LX, m_high=np.ones((N, N)),
              num_snapshots=3, krylov_m=6)
    want = jcompare.integrator_study("nlse", "cubic", u0, **kw)
    got = tcompare.integrator_study("nlse", "cubic", u0, device="cpu",
                                    keep_traj=lambda nx, dt: nx == N, **kw)
    assert len(got) == 4
    assert got[("ss2", N, 1e-3)]["final_snapshot"].dtype == np.complex128
    assert "trajectory" in got[("sewi", N, 1e-3)]
    assert "trajectory" not in got[("sewi", N // 2, 1e-3)]
    _cells_close(got, want, 1e-10)
    _diffs_close(got, want, ("ss2", "sewi"))


def test_integrator_study_realwave_matches_jax():
    """Sine-Gordon kink, Gautschi and SV, float64, two grids and two dt."""
    x = np.linspace(-LX, LX, N)
    u0 = 4 * np.arctan(np.exp(x[:, None] + 0 * x[None, :]))
    rng = np.random.default_rng(0)
    kw = dict(integrators=("gautschi", "sv"), nx_values=[N, 24],
              dt_values=[1e-3, 5e-4], T=0.01, Lx=LX,
              v0_high=0.1 * rng.standard_normal((N, N)),
              m_high=1.0 + 0.1 * rng.random((N, N)), num_snapshots=3,
              krylov_m=6)
    want = jcompare.integrator_study("realwave", "sine_gordon", u0, **kw)
    got = tcompare.integrator_study("realwave", "sine_gordon", u0,
                                    device="cpu", **kw)
    assert len(got) == 8
    assert got[("sv", N, 1e-3)]["final_snapshot"].dtype == np.float64
    _cells_close(got, want, 1e-10)
    for key, w in want.items():
        kin = got[key]["hamiltonian_kinetic"]
        assert np.max(np.abs(kin - w["hamiltonian_kinetic"])
                      / np.abs(w["hamiltonian_kinetic"])) <= 1e-8, key
    _diffs_close(got, want, ("gautschi", "sv"))


def test_complex64_cx_ss2_cell_matches_jax_interpret():
    """One c(x) SS2 cell at 128^2 on the planar path: the port's plain
    versions of K1'/K2'/K3 and kick_bc (no launch on the CPU) against JAX's
    Pallas kernels in interpret mode."""
    n, dt = 128, 1e-3
    x = np.linspace(-LX, LX, n)
    env = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4)
    u0 = env * np.exp(0.4j * x[None, :])
    c = 1.0 + 0.4 * np.random.default_rng(0).random((n, n))
    kw = dict(integrators=("ss2",), nx_values=[n], dt_values=[dt], T=3 * dt,
              Lx=LX, m_high=np.ones((n, n)), c_high=c, num_snapshots=4,
              krylov_m=6)
    prob_kw = dict(m_field=np.ones((n, n)), c_field=c, krylov_m=6)
    assert tproblems.nlse_problem("cubic", (n, n), LX, dt,
                                  dtype=torch.complex64, device="cpu",
                                  **prob_kw).meta["planar_state"]
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        assert jproblems.nlse_problem("cubic", (n, n), LX, dt,
                                      dtype=jnp.complex64,
                                      **prob_kw).meta["planar_state"]
        want = jcompare.integrator_study("nlse", "cubic", u0,
                                         dtype=jnp.complex64, **kw)
    finally:
        jconfig.pallas_mode = old
    counters = (tl.pass1_iso2d, tl.pass1_aniso2d, tl.pipe_iso2d,
                tl.pipe_aniso2d, tl.combine, tkick.phase_kick_bc_planar)
    before = [f.launches for f in counters]
    got = tcompare.integrator_study("nlse", "cubic", u0,
                                    dtype=torch.complex64, device="cpu",
                                    **kw)
    assert [f.launches for f in counters] == before
    g, w = got[("ss2", n, dt)], want[("ss2", n, dt)]
    assert g["nt"] == 3 and g["final_snapshot"].dtype == np.complex64
    assert g["simulation_stable"] and w["simulation_stable"]
    assert _rel(g["final_snapshot"], w["final_snapshot"]) <= 1e-5
    assert np.max(np.abs(g["mass"] - w["mass"]) / w["mass"]) <= 1e-5


STUDY_KW = dict(integrators=("ss2", "sewi"), nx_values=[16, 24],
                dt_values=[0.02, 0.01], T=0.04, Lx=LX,
                phenomenon="colliding_packets",
                ic_params={"kx1": 1.0, "kx2": -1.0}, m_type="constant",
                num_snapshots=4, krylov_m=6, seed=0, animate=False)


@functools.lru_cache(maxsize=None)
def _jax_study(out_dir):
    return jstudy.run_study(out_dir, "nlse", "cubic", **STUDY_KW)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_run_study_matches_jax(tmp_path):
    """tests/test_study.py's study: JAX's artifact names, and a CSV equal
    to JAX's in every column but walltime."""
    want = _jax_study(str(tmp_path / "jax"))
    got = tstudy.run_study(tmp_path / "port", "nlse", "cubic", device="cpu",
                           **STUDY_KW)
    assert sorted(got) == sorted(want)
    for name, path in got.items():
        assert path.split("/")[-1] == want[name].split("/")[-1], name
        assert (tmp_path / "port" / path.split("/")[-1]).stat().st_size > 0
    rows_g, rows_w = _csv(got["summary_csv"]), _csv(want["summary_csv"])
    assert len(rows_g) == len(rows_w) == 8
    assert list(rows_g[0]) == list(rows_w[0]) == list(tstudy.SUMMARY_COLUMNS)
    for rg, rw in zip(rows_g, rows_w):
        for k in ("integrator", "nx", "dt", "T_sim", "simulation_stable"):
            assert rg[k] == rw[k], k
        assert rg["simulation_stable"] == "True"
        assert float(rg["walltime"]) > 0
        for k in ("final_mass_log10_rel_error",
                  "final_hamiltonian_log10_rel_error"):
            assert abs(10 ** float(rg[k]) - 10 ** float(rw[k])) <= 1e-12, k
        assert abs(float(rg["max_abs_hamiltonian_rel_error"])
                   - float(rw["max_abs_hamiltonian_rel_error"])) <= 1e-12
    with open(got["config"]) as f, open(want["config"]) as g:
        assert json.load(f) == json.load(g)


def test_study_cli_realwave(tmp_path):
    """tests/test_study.py's real-wave CLI case, on the CPU."""
    rc = tstudy.main([
        "--family", "realwave", "--kind", "sine_gordon",
        "--integrators", "gautschi", "sv", "--output-dir", str(tmp_path),
        "--nx", "24", "--dt", "0.02", "--T", "0.04",
        "--phenomenon", "kink_solution", "--m-type", "constant",
        "--num-snapshots", "3", "--krylov-m", "6", "--no-animation",
        "--device", "cpu"])
    assert rc == 0
    csvs = list(tmp_path.glob("summary_results_*.csv"))
    assert len(csvs) == 1
    rows = _csv(csvs[0])
    assert {r["integrator"] for r in rows} == {"gautschi", "sv"}
    assert all(r["simulation_stable"] == "True" for r in rows)


def test_study_cli_dtype_and_device(tmp_path, monkeypatch):
    """--dtype picks the torch dtype (default None: complex128 / float64);
    without --device the cells run on the card."""
    seen = {}

    def fake_study(out_dir, family, kind, **kw):
        seen.update(kw)
        return {}

    monkeypatch.setattr(tstudy, "run_study", fake_study)
    args = ["--output-dir", str(tmp_path), "--nx", "16"]
    assert tstudy.main(args + ["--dtype", "complex64"]) == 0
    assert seen["dtype"] is torch.complex64 and seen["device"] == "cuda"
    assert tstudy.main(args + ["--device", "cpu"]) == 0
    assert seen["dtype"] is None and seen["device"] == "cpu"


def _fake_archives(path, n_files=4, diverged=False):
    """tests/test_study.py's fake archives, written by the port."""
    path.mkdir()
    rng = np.random.default_rng(0)
    n = 24
    x = np.linspace(-LX, LX, n)
    base = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4)
    for i in range(n_files):
        u = np.stack([(1 + 0.02 * np.sin(0.3 * s + i)) * base
                      + 0.01j * rng.standard_normal((n, n))
                      for s in range(5)])
        tio.save_run(
            path / f"run_{i}.h5", problem_type="cubic",
            run_id=f"r{i}", run_index=i, phenomenon="test",
            phenomenon_params={}, shape=(n, n), extents=(LX, LX),
            T=1.0, nt=40, num_snapshots=5, u0=u[0], u=u,
            m=np.ones((n, n)), c=1.0 + 0.1 * rng.standard_normal((n, n)))
    if diverged:
        u = np.full((5, n, n), np.nan, complex)
        u[0] = 1.0
        tio.save_run(path / "diverged.h5", problem_type="cubic",
                     run_id="bad", run_index=9, phenomenon="test",
                     phenomenon_params={}, shape=(n, n), extents=(LX, LX),
                     T=1.0, nt=40, num_snapshots=5, u0=u[0], u=u)
    return path


def test_ensemble_dashboard_matches_jax(tmp_path):
    """Three archives and a diverged one (tests/test_study.py's case
    selection): JAX's artifact set and collective stats."""
    base = _fake_archives(tmp_path / "runs", 3, diverged=True)
    want = jdash.ensemble_dashboard(base, tmp_path / "jax", max_workers=2)
    got = tdash.ensemble_dashboard(base, tmp_path / "port", max_workers=2)
    assert sorted(got) == sorted(want) == ["2D_cubic", "collective_stats"]
    group = got["2D_cubic"]
    assert sorted(group) == sorted(want["2D_cubic"]) == [
        "case_snapshots", "energy_plots", "field_info"]
    for key, p in group.items():
        assert p.split("/")[-1] == want["2D_cubic"][key].split("/")[-1]
        assert (tmp_path / "port" / p.split("/")[-1]).stat().st_size > 0
    with open(got["collective_stats"]) as f, \
            open(want["collective_stats"]) as g:
        stats = json.load(f)
        assert stats == json.load(g)
    assert stats["2D_cubic"]["count"] == 4
    assert stats["2D_cubic"]["nan_count"] == 1
