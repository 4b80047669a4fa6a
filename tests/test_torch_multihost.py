"""The port's multi-process runtime: a REAL 2-process CPU cluster (gloo).

The counterpart of tests/test_multihost.py for nlsolvers_tpu_torch: each
test launches this file as a script twice, one process per "host" with 2
CPU devices, joined by parallel/distributed.initialize on a free localhost
port, and runs the multi-process datagen path (every process samples its
own runs from its process_seed stream, drives its host-major block of the
global batch and archives it). Every worker has a hard timeout and one
thread. Checked, as JAX's test checks its cluster:

* per-host archives with disjoint global indices {0, 1} and {2, 3};
* the sweep summary on process 0 only, "4/4 runs archived";
* an archived trajectory recomputed in one process from its archived
  (u0, m, c) within atol 5e-5 (the port's unsharded engine);
* --shard-grid 1,2 across two hosts (each trajectory's grid over a host's
  2 devices, the batch over the hosts) with the mass series;
* resume: a deleted run is re-evolved by the round's every host, the other
  round skipped by both.

In one process, process_seed, local_shards and host_batch_block are held
against JAX's functions on the same numpy inputs. JAX's `--mode dryrun`
test (tests/test_multihost.py:96-101) has no counterpart: it compiles a
JAX sharding, which the port does not have.

Run as a script, this file is the worker:
  python tests/test_torch_multihost.py --pid P --nproc N --port PORT
      --outdir DIR [datagen options]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
THIS = Path(__file__).resolve()
WORKER_TIMEOUT = 270


def _worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--devices-per-host", type=int, default=2)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--num-runs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=10)
    ap.add_argument("--T", type=float, default=0.02)
    ap.add_argument("--snapshots", type=int, default=4)
    ap.add_argument("--krylov-m", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--shard-grid", default="")
    ap.add_argument("--record-energy", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from nlsolvers_tpu_torch.parallel import distributed as dist
    from nlsolvers_tpu_torch.pipeline.datagen import Datagen, DatagenConfig

    dist.initialize(f"localhost:{args.port}", args.nproc, args.pid,
                    local_device_ids=list(range(args.devices_per_host)),
                    platform="cpu")
    try:
        assert dist.process_count() == args.nproc
        assert len(dist.local_devices()) == args.devices_per_host
        shard_grid = (tuple(int(x) for x in args.shard_grid.split(","))
                      if args.shard_grid else ())
        # grid-sharded runs build their (batch, gy, gx) global mesh in
        # Datagen
        mesh = None if shard_grid else dist.global_mesh(("batch",))
        cfg = DatagenConfig(
            family="nlse", phenomenon="multi_soliton", system="cubic",
            nx=args.nx, T=args.T, nt=args.nt, snapshots=args.snapshots,
            num_runs=args.num_runs, batch_size=args.batch_size,
            krylov_m=args.krylov_m, seed=args.seed, output_dir=args.outdir,
            mesh=mesh, shard_grid=shard_grid,
            record_energy=args.record_energy, resume=args.resume,
            device="cpu")
        dg = Datagen(cfg)
        written = dg.run()
        print(json.dumps(dict(pid=args.pid,
                              written=[str(p) for p in written],
                              stats=dg.last_stats,
                              summary=dg.summary_line)), flush=True)
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker())


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_cluster(nproc, outdir, extra=()):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO) + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(THIS), "--pid", str(pid), "--nproc",
         str(nproc), "--port", str(port), "--outdir", str(outdir), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    results = []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker {pid} failed:\n{out}"
            line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
            results.append(json.loads(line))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _recompute(run):
    """The trajectory of an archived run recomputed in this process by the
    port's unsharded engine from its archived u0, m and c."""
    from nlsolvers_tpu_torch.pipeline.engine import make_nlse_trajectory_fn

    u0, m, c = run["u0"], run["focusing/m"], run["c"]
    nt, T = 10, 0.02
    traj = make_nlse_trajectory_fn("cubic", u0.shape, 10.0, T / nt,
                                   krylov_m=6, device="cpu")
    packed = np.stack([u0.real, u0.imag])[None].astype(np.float32)
    out = traj(packed, m[None].astype(np.float32),
               c[None].astype(np.float32), 4, max(1, nt // 4))[0].numpy()
    return out[:, 0] + 1j * out[:, 1]


@pytest.fixture(scope="module")
def cluster_run(tmp_path_factory):
    import torch

    torch.set_num_threads(1)     # the recomputes run in this process
    outdir = tmp_path_factory.mktemp("mh_port")
    return outdir, _launch_cluster(2, outdir)


def test_per_host_shards(cluster_run):
    outdir, results = cluster_run
    assert [len(r["written"]) for r in results] == [2, 2]
    files = sorted((outdir / "hdf5").glob("run_*.h5"))
    assert len(files) == 4
    idxs = sorted(int(f.stem.rsplit("_", 1)[1]) for f in files)
    assert idxs == [0, 1, 2, 3]
    names = [{Path(w).name for w in r["written"]} for r in results]
    assert not names[0] & names[1]
    for want, got in zip(({0, 1}, {2, 3}), names):
        assert {int(n.rsplit("_", 1)[1].split(".")[0]) for n in got} == want


def test_sweep_summary_on_rank_zero(cluster_run):
    _, results = cluster_run
    assert "sweep summary" in results[0]["summary"]
    assert "2 host(s), 4/4 runs archived" in results[0]["summary"]
    assert results[1]["summary"] is None
    for r in results:
        st = r["stats"]
        assert st["archived"] == 2
        assert st["evolve_s"] > 0 and st["wall_s"] >= st["evolve_s"]


def test_cluster_trajectory_matches_single_process(cluster_run):
    from nlsolvers_tpu_torch.pipeline import io_hdf5

    outdir, _ = cluster_run
    files = sorted((outdir / "hdf5").glob("run_*.h5"))
    u0s = []
    for f in files:
        run = io_hdf5.load_run(f)
        u = run["u"]
        assert np.isfinite(u).all()
        np.testing.assert_allclose(u[0], run["u0"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(u, _recompute(run), rtol=0, atol=5e-5)
        u0s.append(run["u0"])
    # each host drew its own stream: no two runs share an IC
    assert all(not np.array_equal(a, b) for i, a in enumerate(u0s)
               for b in u0s[i + 1:])


def test_cluster_grid_sharded_datagen(tmp_path):
    """--shard-grid 1,2 across two hosts: each trajectory's grid over a
    host's 2 devices, the batch over the hosts, the guarded engine and the
    mass series on."""
    from nlsolvers_tpu_torch.pipeline import io_hdf5
    import h5py

    results = _launch_cluster(2, tmp_path, extra=[
        "--num-runs", "1", "--seed", "9", "--shard-grid", "1,2",
        "--record-energy"])
    assert [len(r["written"]) for r in results] == [1, 1]
    files = sorted((tmp_path / "hdf5").glob("run_*.h5"))
    assert [int(f.stem.rsplit("_", 1)[1]) for f in files] == [0, 1]
    dx = 2 * 10.0 / (32 - 1)
    for f in files:
        run = io_hdf5.load_run(f)
        u = run["u"]
        assert np.isfinite(u).all()
        with h5py.File(f, "r") as h:
            mass = np.asarray(h["energy/mass"])
        host_mass = np.sum(np.abs(u) ** 2, axis=(1, 2)) * dx * dx
        np.testing.assert_allclose(mass, host_mass, rtol=1e-4)
        np.testing.assert_allclose(u, _recompute(run), rtol=0, atol=5e-5)


def test_cluster_resume(tmp_path):
    """Each host skips a round only when every host archived it: after run
    3 (host 1, round 1) is deleted, both hosts re-evolve round 1 (host 0
    re-archives run 1, host 1 run 3) and leave round 0 untouched."""
    extra = ["--num-runs", "2", "--batch-size", "1", "--seed", "21",
             "--resume"]
    _launch_cluster(2, tmp_path, extra=extra)
    files = sorted((tmp_path / "hdf5").glob("run_*.h5"))
    assert len(files) == 4
    victim = [f for f in files if f.stem.endswith("_0003")][0]
    victim.unlink()
    mtimes = {f.name: f.stat().st_mtime_ns for f in files if f.exists()}
    r2 = _launch_cluster(2, tmp_path, extra=extra)
    assert [len(r["written"]) for r in r2] == [1, 1]
    assert Path(r2[1]["written"][0]).name == victim.name
    assert Path(r2[0]["written"][0]).stem.endswith("_0001")
    redone = {Path(w).name for r in r2 for w in r["written"]}
    for f in (tmp_path / "hdf5").glob("run_*.h5"):
        if f.name in mtimes and f.name not in redone:
            assert f.stat().st_mtime_ns == mtimes[f.name], f.name


# ------------------------------------------------------------ in one process

def test_process_seed_local_shards_host_batch_block_match_jax():
    """process_seed gives JAX's stream; make_global_batch's shards on a
    (batch,) and a (batch, gy, gx) mesh, and local_shards and
    host_batch_block of those and of a grid-sharded array, equal JAX's on
    the same numpy data (one process, 8 devices on both sides)."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec as PS

    import torch

    from nlsolvers_tpu.parallel import distributed as jdist
    from nlsolvers_tpu_torch.parallel import distributed as tdist
    from nlsolvers_tpu_torch.parallel import mesh as tmesh

    for seed in (0, 7, 2**40 + 3):
        for pid in range(3):
            a = tdist.process_seed(seed, pid)
            b = jdist.process_seed(seed, pid)
            assert np.array_equal(a.generate_state(4), b.generate_state(4))
            assert np.array_equal(np.random.default_rng(a).random(5),
                                  np.random.default_rng(b).random(5))
    assert np.array_equal(tdist.process_seed(5).generate_state(2),
                          jdist.process_seed(5).generate_state(2))
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x = np.arange(8 * 3 * 4 * 6, dtype=np.float32).reshape(8, 3, 4, 6)

    def same_blocks(tarr, jarr):
        assert tarr.shape == jarr.shape
        jl, tl = jdist.local_shards(jarr), tdist.local_shards(tarr)
        assert [s for s, _ in tl] == [s for s, _ in jl]
        for (_, a), (_, b) in zip(sorted(tl, key=lambda t: (t[0], t[1].sum())),
                                  sorted(jl, key=lambda t: (t[0],
                                                            t[1].sum()))):
            np.testing.assert_array_equal(a, b)
        for nproc, pid in ((1, 0), (2, 1), (4, 2)):
            tb, trows = tdist.host_batch_block(tarr, nproc, pid)
            jb, jrows = jdist.host_batch_block(jarr, nproc, pid)
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(trows, jrows)

    # make_global_batch on a batch-only and a (batch, gy, gx) mesh, the
    # batch split and every other axis replicating it, as JAX's
    for shape, axes in (((8,), ("batch",)),
                        ((2, 2, 2), ("batch", "gy", "gx"))):
        jm = JMesh(np.array(jax.devices()[:8]).reshape(shape), axes)
        tm = tmesh.make_mesh(axes, shape, devices=["cpu"] * 8)
        same_blocks(tdist.make_global_batch(tm, x),
                    jdist.make_global_batch(jm, x))
    # a grid-sharded run's output layout, P("batch", None, "gy", "gx"),
    # its shards built here from their global indices
    jm = JMesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
               ("batch", "gy", "gx"))
    jarr = jax.device_put(x, NamedSharding(jm, PS("batch", None, "gy", "gx")))
    parts = []
    for b in range(2):
        for gy in range(2):
            for gx in range(2):
                index = (slice(4 * b, 4 * b + 4), slice(None),
                         slice(2 * gy, 2 * gy + 2), slice(3 * gx, 3 * gx + 3))
                parts.append(tdist.Shard(index, torch.from_numpy(x[index])))
    same_blocks(tdist.GlobalArray(x.shape, parts), jarr)
    gm = tmesh.make_mesh(("batch", "gy"), (2, 2), devices=["cpu"] * 4)
    assert tdist.local_mesh(gm).shape == (2, 2)
    assert tdist.process_allgather(np.arange(3)).shape == (1, 3)
