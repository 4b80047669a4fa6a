"""Datagen and the CLI on the port's grid-sharded engines, on the CPU.

The counterpart of tests/test_datagen.py:225-375 for the port: the sweeps
run with `shard_grid` (each trajectory's grid split over a single-process
mesh whose shards all sit on the CPU, `device="cpu"`), and are held against
the port's unsharded sweep of the same config and seed and against the JAX
package's sharded sweep on the 8 virtual CPU devices of tests/conftest.py.

Gates (JAX's own, tests/test_datagen.py): the sampled u0 and c equal, u
within rtol 2e-4, atol 2e-5 (float32 planar against the unsharded planar
path and against JAX's generic sharded Lanczos); the recorded mass series
within 1e-5 of the host mass of the archived snapshots.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from nlsolvers_tpu.pipeline import datagen as jdg
from nlsolvers_tpu_torch.pipeline import __main__ as tcli
from nlsolvers_tpu_torch.pipeline import datagen as tdg
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio

torch.set_num_threads(1)

N, LX = 32, 5.0
U_GATE = dict(rtol=2e-4, atol=2e-5)


def _cfg(mod, tmp, **kw):
    base = dict(family="nlse", phenomenon="multi_soliton", system="cubic",
                nx=N, Lx=LX, T=0.01, nt=10, snapshots=3, num_runs=2,
                batch_size=2, anisotropy_type="periodic_structure",
                m_type="piecewise", krylov_m=6, seed=11, resume=True,
                output_dir=str(tmp))
    if mod is tdg:
        base["device"] = "cpu"
    base.update(kw)
    return mod.DatagenConfig(**base)


def test_datagen_grid_sharded_matches_unsharded_and_jax(tmp_path):
    """shard_grid=(2, 4): the archives' u0 and c equal the unsharded run's
    and the JAX package's sharded run's (same seed, same draws), u within
    JAX's gate of both; the run ids and file names are JAX's."""
    ref = tdg.Datagen(_cfg(tdg, tmp_path / "ref")).run()
    td = tdg.Datagen(_cfg(tdg, tmp_path / "shard", shard_grid=(2, 4)))
    assert td.traj_fn.batched
    got = td.run()
    jd = jdg.Datagen(_cfg(jdg, tmp_path / "jax", shard_grid=(2, 4)))
    assert jd.run_id == td.run_id
    jax_paths = jd.run()
    assert [p.name for p in got] == [p.name for p in jax_paths]
    assert len(got) == len(ref) == 2
    for rp, gp, jp in zip(ref, got, jax_paths):
        r, g, j = tio.load_run(rp), tio.load_run(gp), tio.load_run(jp)
        assert g["u"].shape == (3, N, N) and np.isfinite(g["u"]).all()
        for other in (r, j):
            np.testing.assert_array_equal(g["u0"], other["u0"])
            np.testing.assert_array_equal(g["c"], other["c"])
            np.testing.assert_allclose(g["u"], other["u"], **U_GATE)


def test_datagen_grid_sharded_realwave(tmp_path):
    """A sine-Gordon Gautschi sweep (float32, the shard kernels' plain
    versions at P=1) on (2, 4): finite u and v of the expected shape (JAX's
    test), u0 and c equal to the unsharded sweep's, u within rel-L2 2e-4 of
    it (the sharded-vs-unsharded gate; the kink's values reach 4 pi, so
    the elementwise atol of the NLSE gate does not apply)."""
    kw = dict(family="realwave", phenomenon="kink_field",
              system="sine_gordon", num_runs=1, batch_size=1, seed=5)
    got = tdg.Datagen(_cfg(tdg, tmp_path / "shard", shard_grid=(2, 4),
                           **kw)).run()
    ref = tdg.Datagen(_cfg(tdg, tmp_path / "ref", **kw)).run()
    g, r = tio.load_run(got[0]), tio.load_run(ref[0])
    assert g["u"].shape == g["v"].shape == (3, N, N)
    assert np.isfinite(g["u"]).all() and np.isfinite(g["v"]).all()
    np.testing.assert_array_equal(g["u0"], r["u0"])
    np.testing.assert_array_equal(g["c"], r["c"])
    assert (np.linalg.norm(g["u"] - r["u"]) / np.linalg.norm(r["u"])
            <= 2e-4)


def test_datagen_grid_sharded_guard_energy(tmp_path):
    """--shard-grid with --record-energy: the archive's energy/mass series,
    summed over every shard, matches the host mass of the archived
    trajectory within 1e-5."""
    written = tdg.Datagen(_cfg(tdg, tmp_path, shard_grid=(2, 4), num_runs=1,
                               batch_size=1, guard=True,
                               record_energy=True)).run()
    assert len(written) == 1
    with h5py.File(written[0], "r") as f:
        mass = np.asarray(f["energy/mass"])
        u = np.asarray(f["u"])
    assert mass.shape == (3,)
    dx = 2 * LX / (N - 1)
    host = np.sum(np.abs(u) ** 2, axis=(1, 2)) * dx * dx
    np.testing.assert_allclose(mass, host, rtol=1e-5)


def test_datagen_grid_sharded_guard_skips_diverging_run(tmp_path):
    """A diverging Klein-Gordon SV run on the grid-sharded engine is caught
    by the guard (every shard's block in the gathered snapshot) and
    skipped, not archived."""
    cfg = _cfg(tdg, tmp_path, family="realwave", phenomenon="kink_field",
               system="klein_gordon", T=500.0, nt=10, snapshots=5,
               num_runs=1, batch_size=1, integrator="sv", seed=3,
               shard_grid=(2, 4), guard=True)
    assert tdg.Datagen(cfg).run() == []
    assert list((tmp_path / "hdf5").glob("*.h5")) == []


@pytest.mark.parametrize("fmt", ["npy", "hdf5"])
def test_cli_shard_grid(tmp_path, capsys, fmt):
    """python -m nlsolvers_tpu_torch.pipeline nlse ... --shard-grid 2,4
    --device cpu writes the runs, equal to the same CLI run without it
    within the gate."""
    args = ["nlse", "--phenomenon", "multi_soliton", "--nx", str(N),
            "--T", "0.01", "--nt", "8", "--snapshots", "2", "--num-runs",
            "2", "--krylov-m", "6", "--anisotropy-type", "layered",
            "--resume", "--format", fmt, "--device", "cpu"]
    assert tcli.main(args + ["--shard-grid", "2,4", "--output-dir",
                             str(tmp_path / "shard")]) == 0
    assert "wrote 2 archives" in capsys.readouterr().out
    assert tcli.main(args + ["--output-dir", str(tmp_path / "ref")]) == 0
    # the run ids differ (shard_grid is part of the config digest, as in
    # JAX's), so the runs pair by index
    if fmt == "npy":
        runs = sorted((tmp_path / "shard" / "npy").glob("run_*.json"))
        refs = sorted((tmp_path / "ref" / "npy").glob("run_*.json"))
        assert len(runs) == len(refs) == 2
        for p, q in zip(runs, refs):
            assert json.loads(p.read_text())["shape"] == [N, N]
            np.testing.assert_allclose(
                np.load(p.with_name(p.stem + "_u.npy")),
                np.load(q.with_name(q.stem + "_u.npy")), **U_GATE)
    else:
        runs = sorted((tmp_path / "shard" / "hdf5").glob("run_*.h5"))
        refs = sorted((tmp_path / "ref" / "hdf5").glob("run_*.h5"))
        assert len(runs) == len(refs) == 2
        for p, q in zip(runs, refs):
            np.testing.assert_allclose(tio.load_run(p)["u"],
                                       tio.load_run(q)["u"], **U_GATE)


def test_3d_reference_split_and_batch_mesh_raise(tmp_path):
    """A 3D reference-variant sweep split along z or y raises JAX's
    ValueError (the y-seam is not shard-local), with or without a batch
    axis in the mesh (--shard-batch with --shard-grid)."""
    with pytest.raises(ValueError, match="unsplit z"):
        tdg.Datagen(_cfg(tdg, tmp_path, dim=3, nx=8,
                         phenomenon="multi_soliton_state",
                         shard_grid=(2, 1, 1)))
    with pytest.raises(ValueError, match="unsplit z"):
        tcli.main(["nlse", "--phenomenon", "multi_soliton_state", "--dim",
                   "3", "--nx", "8", "--shard-grid", "1,2,1",
                   "--shard-batch", "2", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
