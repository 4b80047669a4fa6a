"""Datagen launchers: sample -> evolve (batched) -> downsample -> archive.

Port of nlsolvers_tpu/pipeline/datagen.py: the same config, run ids,
sampler draws, archive layouts (the reference HDF5 schema of
pipeline/io_hdf5.py, or the npy files of the native writer) and resume
rules, so a sweep gives the same ICs, fields, manifest and file names as
the JAX package's for the same config, seed and mesh, and `resume` skips
what either package archived. A batch of trajectories runs on the port's
engine (pipeline/engine.py) on `device`, the card unless the config asks
for the CPU; with device "cuda" and no card, Datagen raises. Downsampling
stays on the host after readback, in float64 (pipeline/downsample.py).

`mesh` with the axis `batch_axis` splits each batch over that axis, as the
JAX package's engine does; the batch is padded up to a multiple of the
axis by sampling more runs, which are evolved and not archived (the pad
draws keep the sampler stream, and so the archived ICs, equal to JAX's for
the same (seed, mesh, batch_size)). `shard_grid` splits each trajectory's
grid over a mesh of that shape, as the JAX package's
`_build_grid_sharded_traj_fn`: the grid-sharded engines of
parallel/spatial.py, every shard on the config's device unless `mesh` is
given (with a batch axis too: a (batch, *grid) mesh), all lanes of a
sub-mesh in one batched sharded step; their outputs are global tensors.

In a process group (parallel/distributed.py) every process runs this same
sweep: num_runs is per process, each process samples its own runs from its
process_seed stream, drives its host-major block of the global batch on its
part of the global mesh (distributed.local_mesh) and archives it under the
global run indices pid*num_runs + offset + b, in the shared deterministic
run id; process 0 writes the manifest and prints the sweep summary of every
process (allgathered), and a resume round is skipped only when every
process has archived it.
"""

import json
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from nlsolvers_tpu_torch.parallel import distributed as dist
from nlsolvers_tpu_torch.parallel import spatial
from nlsolvers_tpu_torch.parallel.mesh import make_mesh
from nlsolvers_tpu_torch.pipeline import downsample as ds
from nlsolvers_tpu_torch.pipeline import fields as field_gen
from nlsolvers_tpu_torch.pipeline import io_hdf5, spaces
from nlsolvers_tpu_torch.pipeline.engine import (make_nlse_trajectory_fn,
                                                 make_realwave_trajectory_fn)
from nlsolvers_tpu_torch.pipeline.grids import Grid2D, Grid3D
from nlsolvers_tpu_torch.pipeline.samplers.nlse2d import NLSEPhenomenonSampler
from nlsolvers_tpu_torch.pipeline.samplers.nlse3d import NLSE3DSampler
from nlsolvers_tpu_torch.pipeline.samplers.realwave2d import RealWaveSampler
from nlsolvers_tpu_torch.pipeline.samplers.realwave3d import RealWaveSampler3d

__all__ = ["DatagenConfig", "Datagen", "draw_from_space"]

NLSE_SYSTEMS = ("cubic", "cubic_quintic", "saturable")


class _Done:
    """Pre-resolved future (synchronous archive mode)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


def draw_from_space(rng, space):
    """One concrete parameter draw from a dict-of-candidate-lists space
    (parity: complex_launcher_2d.py sample_phenomenon_params:102-115 — every
    value list is a uniform categorical, tuple entries picked whole)."""
    params = {}
    for key, values in space.items():
        idx = int(rng.integers(len(values)))
        params[key] = values[idx]
    return params


@dataclass
class DatagenConfig:
    family: str                      # "nlse" | "realwave"
    phenomenon: str
    system: str = "cubic"            # equation kind within the family
    dim: int = 2
    nx: int = 128
    Lx: float = 10.0
    T: float = 1.5
    nt: int = 500
    snapshots: int = 100
    num_runs: int = 1
    batch_size: int = 0              # 0 -> one batch of num_runs
    integrator: str = ""             # "" -> family default (ss2 / gautschi)
    anisotropy_type: str = "constant"
    m_type: str = "constant"
    m0: float = 1.0
    sigma1: float = 1.0
    sigma2: float = -0.1
    kappa: float = 1.0
    noise_strength: float = 0.1
    krylov_m: int = 0                # 0 -> reference defaults per system/dim
    dtype: str = ""                  # "" -> complex64 / float32
    variant: str = "reference"
    dr_target: int = 0               # 0 -> no downsampling
    dr_strategy: str = "interpolation"
    seed: int = 0
    output_dir: str = "datagen_out"
    mesh: object = None              # parallel/mesh.Mesh to shard the
    #                                  batch axis over (and, with
    #                                  shard_grid, the grid's shards)
    batch_axis: str = "batch"
    shard_grid: tuple = ()           # e.g. (2, 4): shard EACH grid over the
    #                                  mesh's spatial axes (gy, gx) /
    #                                  (gz, gy, gx) — for single trajectories
    #                                  too large for one card
    normalize_ic: bool = True        # NLSE only (complex_launcher_2d.py:95)
    boundary: str = "noflux"         # NLSE: "noflux" | "radiating" | "none"
    #                                  (radiating: boundaries.hpp:59-121)
    guard: bool = True               # in-loop stability guard: on-device
    #                                  per-snapshot finiteness + early exit
    #                                  when every lane in a batch diverged
    #                                  (gen-2 analogue: sg_solver_dev.hpp:7-90)
    record_energy: bool = False      # record mass (NLSE) / energy (realwave)
    #                                  per snapshot ON DEVICE during
    #                                  generation; archived under energy/
    archive_async: bool = False      # archive runs on background threads.
    #                                  OFF by default, as in the JAX
    #                                  package: h5py holds the GIL, so
    #                                  worker-thread writes contend with the
    #                                  host's work for the next batch. The
    #                                  npy format instead
    #                                  streams through the NATIVE writer's
    #                                  C++ thread pool (no GIL), which is
    #                                  async regardless of this flag.
    archive_format: str = "hdf5"     # "hdf5" (reference schema) | "npy"
    #                                  (native AsyncNpyWriter trajectory
    #                                  files + JSON sidecar — the reference
    #                                  device drivers' own output format,
    #                                  util.hpp:37-92)
    resume: bool = False             # sweep resume: makes the run id
    #                                  seed-derived (deterministic) and, on
    #                                  relaunch, skips every batch whose
    #                                  runs are all already archived while
    #                                  consuming the same sampler RNG draws
    #                                  — the remaining runs are identical to
    #                                  what the original sweep would have
    #                                  produced. Batches with missing runs
    #                                  (crash mid-write, or runs skipped by
    #                                  the stability guard) re-evolve whole;
    #                                  guard-skipped runs deterministically
    #                                  diverge and are skipped again.
    #                                  The JAX package's run ids and files
    #                                  count as archived. The reference
    #                                  has no resume at all — a dead SLURM
    #                                  task re-runs from scratch (SURVEY.md
    #                                  §5 checkpoint/resume).
    device: str = "cuda"             # where the engine runs: the card, or
    #                                  "cpu" when asked; not part of the run
    #                                  id (the JAX package's ids and files)

    def __post_init__(self):
        assert self.family in ("nlse", "realwave")
        assert self.dim in (2, 3)
        assert self.archive_format in ("hdf5", "npy")
        if self.shard_grid:
            self.shard_grid = tuple(int(g) for g in self.shard_grid)
            if len(self.shard_grid) != self.dim:
                raise ValueError(f"shard_grid {self.shard_grid} must have "
                                 f"one entry per grid axis (dim={self.dim})")
        if not self.integrator:
            self.integrator = "ss2" if self.family == "nlse" else "gautschi"
        if not self.dtype:
            self.dtype = "complex64" if self.family == "nlse" else "float32"
        if not self.krylov_m:
            if self.family == "nlse" and self.dim == 2:
                self.krylov_m = {"cubic": 20, "cubic_quintic": 15,
                                 "saturable": 15}.get(self.system, 20)
            else:
                self.krylov_m = 10
        if not self.batch_size:
            self.batch_size = self.num_runs

    @property
    def shape(self):
        return (self.nx,) * self.dim

    @property
    def extents(self):
        return (self.Lx,) * self.dim

    @property
    def dt(self):
        return self.T / self.nt

    @property
    def snapshot_freq(self):
        return max(1, self.nt // self.snapshots)


class Datagen:
    """Runs a datagen sweep: num_runs trajectories in batches, each archived
    as hdf5/run_<id>_<idx>.h5 under output_dir (+ a params_<id>.txt manifest,
    complex_launcher_2d.py:60-69)."""

    def __init__(self, config):
        self.cfg = config
        cfg = config
        # In a process group every process runs this same code; each one
        # samples, evolves and archives only its own block of the batch.
        self.nproc = dist.process_count()
        self.pid = dist.process_index()
        if (torch.device(cfg.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"Datagen: device {cfg.device!r} but torch sees no CUDA "
                f"device; the engine never moves to the CPU unless the "
                f"config asks for device='cpu'")
        # Deterministic ids carry a config digest: two sweeps sharing a seed
        # but differing in physics/grid/format must not alias in one
        # output_dir, or resume would silently skip batches the second sweep
        # never ran (the archived files would also be overwritten). The
        # digest is derived from the config fields that determine what gets
        # archived, so it is identical on every host.
        det_id = f"{cfg.seed & 0xFFFFFFFF:08x}-{self._config_digest()}"
        det_id = self._adopt_legacy_id(det_id)
        if self.nproc > 1:
            # deterministic id shared by every process (the reference
            # bcasts rank 0's run id, submit_nlse.py:96-102)
            self.run_id = det_id
            seed_seq = dist.process_seed(cfg.seed, self.pid)
            self.rng = np.random.default_rng(seed_seq)
            sampler_seed = int(seed_seq.generate_state(2)[1])
        else:
            # resumable sweeps need a relaunch-stable id; otherwise keep the
            # collision-free uuid (reruns into one dir never overwrite)
            self.run_id = det_id if cfg.resume else str(uuid.uuid4())[:8]
            self.rng = np.random.default_rng(cfg.seed)
            sampler_seed = cfg.seed
        self._sampler_seed = sampler_seed
        self.grid = (Grid2D(cfg.nx, cfg.nx, cfg.Lx) if cfg.dim == 2
                     else Grid3D(cfg.nx, cfg.nx, cfg.nx, cfg.Lx))

        self.out = Path(cfg.output_dir)
        self.h5_dir = self.out / cfg.archive_format
        self.h5_dir.mkdir(parents=True, exist_ok=True)
        if self.pid == 0:
            self._write_manifest()

        # archive workers: downsample + disk IO run off the critical path so
        # they overlap the next batch's device compute (the reference's
        # store_snapshot_online/cudaMemcpyAsync + save loop is synchronous,
        # nlse_dev.hpp:323-334). npy format streams through the native
        # thread-pool writer (native/snapshot_writer.cpp) — zero GIL.
        self._archiver = (ThreadPoolExecutor(max_workers=2)
                          if cfg.archive_async else None)
        self._npy_writer = None
        if cfg.archive_format == "hdf5":
            io_hdf5.h5py_or_raise()     # before any batch is evolved
        if cfg.archive_format == "npy":
            from nlsolvers_tpu_torch import native
            try:
                self._npy_writer = native.AsyncNpyWriter(n_threads=2)
            except native.NativeUnavailable as e:
                print(f"native npy writer unavailable ({e}); "
                      "falling back to numpy.save")

        if cfg.family == "nlse":
            self.sampler = (
                NLSEPhenomenonSampler(cfg.nx, cfg.nx, cfg.Lx,
                                      seed=sampler_seed)
                if cfg.dim == 2
                else NLSE3DSampler(cfg.nx, cfg.nx, cfg.nx, cfg.Lx,
                                   seed=sampler_seed))
            self.space = self._space_for("nlse")
        else:
            self.sampler = (
                RealWaveSampler(cfg.nx, cfg.nx, cfg.Lx, seed=sampler_seed)
                if cfg.dim == 2
                else RealWaveSampler3d(cfg.nx, cfg.nx, cfg.nx, cfg.Lx,
                                       seed=sampler_seed))
            self.space = self._space_for("realwave")
        self.traj_fn = self._build_traj_fn()

    def _local_mesh(self):
        """The part of cfg.mesh this process drives: the mesh itself in one
        process, this process's batch indices of the global mesh in a
        group."""
        mesh = self.cfg.mesh
        if self.nproc > 1:
            return dist.local_mesh(mesh, self.cfg.batch_axis)
        return mesh

    def _build_traj_fn(self):
        cfg = self.cfg
        if cfg.shard_grid:
            return self._build_grid_sharded_traj_fn()
        if self.nproc > 1 and cfg.mesh is None:
            raise ValueError("a multi-process sweep needs the global batch "
                             "mesh (parallel/distributed.global_mesh)")
        mesh = None if cfg.mesh is None else self._local_mesh()
        if cfg.family == "nlse":
            return make_nlse_trajectory_fn(
                cfg.system, cfg.shape, cfg.Lx, cfg.dt,
                integrator=cfg.integrator, krylov_m=cfg.krylov_m,
                sigma1=cfg.sigma1, sigma2=cfg.sigma2, kappa=cfg.kappa,
                dtype=cfg.dtype, variant=cfg.variant, mesh=mesh,
                batch_axis=cfg.batch_axis, guard=cfg.guard,
                record_energy=cfg.record_energy, boundary=cfg.boundary,
                device=cfg.device)
        return make_realwave_trajectory_fn(
            cfg.system, cfg.shape, cfg.Lx, cfg.dt,
            integrator=cfg.integrator, krylov_m=cfg.krylov_m,
            noise_strength=cfg.noise_strength, seed=cfg.seed,
            dtype=cfg.dtype, variant=cfg.variant, mesh=mesh,
            batch_axis=cfg.batch_axis, guard=cfg.guard,
            record_energy=cfg.record_energy, device=cfg.device)

    def _build_grid_sharded_traj_fn(self):
        """The grid-sharded engines (parallel/spatial.py): every
        trajectory's GRID is split over the mesh's spatial axes, the path
        for single runs too large for one card (1024^2 / 256^3 configs).
        One process: the mesh's shards all on cfg.device unless cfg.mesh is
        given, the batch split over its batch axis if it has one. A group:
        the batch over the processes, each trajectory's grid over each
        process's devices, a (nproc, *shard_grid) global mesh whose batch
        axis leads (JAX datagen.py:289-303)."""
        cfg = self.cfg
        axes = ("gy", "gx") if cfg.dim == 2 else ("gz", "gy", "gx")
        if self.nproc > 1:
            n = int(np.prod(cfg.shard_grid))
            local = dist.local_devices()
            if n != len(local):
                raise ValueError(
                    f"--shard-grid {cfg.shard_grid} needs exactly the "
                    f"{len(local)} local devices per host (got {n}); the "
                    f"batch axis spans hosts")
            if cfg.mesh is None:
                cfg.mesh = dist.global_mesh(
                    (cfg.batch_axis,) + axes,
                    shape=(self.nproc,) + tuple(cfg.shard_grid))
            batch_ax = cfg.batch_axis
        else:
            if cfg.mesh is None:
                n = int(np.prod(cfg.shard_grid))
                cfg.mesh = make_mesh(axes, shape=cfg.shard_grid,
                                     devices=[cfg.device] * n)
            batch_ax = (cfg.batch_axis if cfg.batch_axis in cfg.mesh.axis_names
                        else None)
        mesh = self._local_mesh()
        if cfg.family == "nlse":
            return spatial.make_sharded_nlse_trajectory_fn(
                cfg.system, cfg.shape, cfg.Lx, cfg.dt, mesh,
                axis_names=axes, batch_axis=batch_ax,
                integrator=cfg.integrator, krylov_m=cfg.krylov_m,
                sigma1=cfg.sigma1, sigma2=cfg.sigma2, kappa=cfg.kappa,
                dtype=cfg.dtype, variant=cfg.variant, guard=cfg.guard,
                record_energy=cfg.record_energy)
        return spatial.make_sharded_realwave_trajectory_fn(
            cfg.system, cfg.shape, cfg.Lx, cfg.dt, mesh, axis_names=axes,
            batch_axis=batch_ax, integrator=cfg.integrator,
            krylov_m=cfg.krylov_m, dtype=cfg.dtype, variant=cfg.variant,
            guard=cfg.guard, record_energy=cfg.record_energy)

    def _adopt_legacy_id(self, det_id):
        """Resume migration: sweeps archived before the config digest was
        folded into the run id used a plain 8-hex seed id. If resuming and
        nothing exists under the new id but legacy files do, adopt the
        legacy id so completed work is not silently redone. The decision
        scans the shared output dir, so every process reaches the same
        answer without a collective."""
        cfg = self.cfg
        if not cfg.resume and self.nproc <= 1:
            return det_id
        fmt = "h5" if cfg.archive_format == "hdf5" else "json"
        arch = Path(cfg.output_dir) / cfg.archive_format
        if next(arch.glob(f"run_{det_id}_*.{fmt}"), None) is not None:
            return det_id
        legacy = f"{cfg.seed & 0xFFFFFFFF:08x}"
        if next(arch.glob(f"run_{legacy}_*.{fmt}"), None) is not None:
            if self.pid == 0:
                print(f"resume: adopting pre-digest run id {legacy} "
                      f"(archives found under the legacy naming)")
            return legacy
        return det_id

    def _config_digest(self):
        """8-hex digest of every config field that shapes the archived data
        (grid/physics/sampling/format). Excludes runtime-only knobs (mesh
        object, output_dir, resume, archive_async, and the port's device) so
        relaunches with the same sweep definition keep the same id, which is
        the JAX package's id for the same sweep."""
        import hashlib
        cfg = self.cfg
        keyed = {k: getattr(cfg, k) for k in (
            "family", "phenomenon", "system", "dim", "nx", "Lx", "T", "nt",
            "snapshots", "num_runs", "batch_size", "integrator",
            "anisotropy_type", "m_type", "m0", "sigma1", "sigma2", "kappa",
            "noise_strength", "krylov_m", "dtype", "variant", "dr_target",
            "dr_strategy", "normalize_ic", "boundary", "guard",
            "record_energy", "archive_format", "shard_grid")}
        blob = json.dumps(keyed, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:8]

    def _space_for(self, family):
        cfg = self.cfg
        if family == "nlse":
            table = (spaces.nlse_parameter_spaces() if cfg.dim == 2
                     else spaces.nlse_parameter_spaces_3d())
        else:
            table = (spaces.realwave_parameter_spaces(cfg.Lx) if cfg.dim == 2
                     else spaces.realwave_parameter_spaces_3d(cfg.Lx))
        if cfg.phenomenon not in table:
            raise ValueError(
                f"unknown phenomenon {cfg.phenomenon!r} for {family} "
                f"{cfg.dim}D; known: {sorted(table)}")
        return table[cfg.phenomenon]

    def _write_manifest(self):
        cfg = self.cfg
        lines = [f"Run ID: {self.run_id}",
                 f"Family: {cfg.family} ({cfg.system}, {cfg.integrator})",
                 f"Grid: {'x'.join([str(cfg.nx)] * cfg.dim)}",
                 f"Domain: half-width {cfg.Lx}",
                 f"Time: T={cfg.T}, steps={cfg.nt}, "
                 f"snapshots={cfg.snapshots}",
                 f"Phenomenon: {cfg.phenomenon}",
                 f"Anisotropy: {cfg.anisotropy_type}",
                 f"Amplification: {cfg.m_type}",
                 f"Seed: {cfg.seed}"]
        (self.out / f"params_{self.run_id}.txt").write_text(
            "\n".join(lines) + "\n")

    # -- per-run host-side sampling -------------------------------------
    def _sample_ic(self, params):
        cfg = self.cfg
        params = dict(params)
        if cfg.family == "nlse":
            system = params.pop("system_type", None)
            if system is None:
                system = (cfg.system if cfg.system in NLSE_SYSTEMS
                          else "cubic")
            sample = self.sampler.generate_sample(cfg.phenomenon,
                                                  system_type=system,
                                                  **params)
            u0 = np.asarray(sample)
            if cfg.normalize_ic:
                peak = np.max(np.abs(u0))
                if peak > 0:
                    u0 = u0 / peak
            return u0, None
        params.pop("system_type", None)
        system = cfg.system if cfg.system != "stochastic_phi4" else "phi4"
        u0, v0 = self.sampler.generate_sample(
            system_type=system, phenomenon_type=cfg.phenomenon, **params)
        return np.asarray(u0), np.asarray(v0)

    def _sample_fields(self):
        cfg = self.cfg
        c, c_params = field_gen.sample_c_field(self.grid, self.rng,
                                               kind=cfg.anisotropy_type)
        m, m_params = field_gen.sample_m_field(self.grid, self.rng,
                                               kind=cfg.m_type, c=c,
                                               m0=cfg.m0)
        return c, m, c_params, m_params

    def _sample_batch(self, batch):
        metas, u0s, v0s, ms, cs = [], [], [], [], []
        for _ in range(batch):
            params = draw_from_space(self.rng, self.space)
            u0, v0 = self._sample_ic(params)
            c, m, c_params, m_params = self._sample_fields()
            metas.append((params, c_params, m_params))
            u0s.append(u0)
            v0s.append(v0)
            ms.append(m)
            cs.append(c)
        return metas, u0s, v0s, np.stack(ms), np.stack(cs)

    # -- evolution ------------------------------------------------------
    # Dispatch and fetch are split as in the JAX package: dispatch runs the
    # batch on the engine and returns device tensors (the host has queued
    # the last kernels when it returns), fetch reads them back to numpy;
    # run() dispatches batch k+1 before it fetches and archives batch k.
    @staticmethod
    def _host(arr):
        """A batch read back from the device as numpy."""
        return arr.cpu().numpy()

    def _dispatch_nlse(self, u0s, m, c):
        cfg = self.cfg
        u0 = np.stack(u0s)
        packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32
                          if cfg.dtype == "complex64" else np.float64)
        return self.traj_fn(packed, m.astype(packed.dtype),
                            c.astype(packed.dtype), cfg.snapshots,
                            cfg.snapshot_freq)

    def _fetch_nlse(self, dev_out):
        """Returns (u_traj, bad_at, series); bad_at/series None unguarded."""
        bad_at, series = None, None
        if self.cfg.guard:
            if self.cfg.record_energy:
                dev_out, bad_dev, series_dev = dev_out
                series = {k: self._host(v)
                          for k, v in series_dev.items()}
            else:
                dev_out, bad_dev = dev_out
            bad_at = self._host(bad_dev)
        out = self._host(dev_out)                   # (B, S, 2, *shape)
        u = out[:, :, 0] + 1j * out[:, :, 1]        # complex (B, S, *shape)
        return u, bad_at, series

    def _dispatch_realwave(self, u0s, v0s, m, c):
        cfg = self.cfg
        rdt = np.float32 if cfg.dtype == "float32" else np.float64
        u0 = np.stack(u0s).astype(rdt)
        v0 = np.stack(v0s).astype(rdt)
        return self.traj_fn(u0, v0, m.astype(rdt), c.astype(rdt),
                            cfg.snapshots, cfg.snapshot_freq)

    def _fetch_realwave(self, dev_out):
        """Returns (u_traj, v_traj, bad_at, series) as in _fetch_nlse."""
        bad_at, series = None, None
        if self.cfg.guard:
            if self.cfg.record_energy:
                u_t, v_t, bad_dev, series_dev = dev_out
                series = {k: self._host(v)
                          for k, v in series_dev.items()}
            else:
                u_t, v_t, bad_dev = dev_out
            bad_at = self._host(bad_dev)
        else:
            u_t, v_t = dev_out
        return self._host(u_t), self._host(v_t), bad_at, series

    def _downsample(self, traj):
        cfg = self.cfg
        if not cfg.dr_target or cfg.dr_strategy == "none":
            return traj
        target = (cfg.dr_target,) * cfg.dim
        return ds.downsample_trajectory(traj, target, *cfg.extents,
                                        method=cfg.dr_strategy.lower()
                                        if cfg.dr_strategy != "FFT"
                                        else "fft")

    # -- archiving ------------------------------------------------------
    def _archive_run(self, idx, meta, u0, v0, m_b, c_b, u_b, v_b, scal,
                     per_run):
        """Downsample + persist one run; runs on an archiver thread in
        async mode. Returns the written path."""
        cfg = self.cfg
        params, c_params, m_params = meta
        if cfg.archive_format == "npy":
            return self._archive_run_npy(idx, params, c_params, m_params,
                                         u0, v0, m_b, c_b, u_b, v_b, scal,
                                         per_run)
        path = self.h5_dir / f"run_{self.run_id}_{idx:04d}.h5"
        io_hdf5.save_run(
            path,
            problem_type=cfg.system,
            run_id=self.run_id, run_index=idx,
            phenomenon=cfg.phenomenon, phenomenon_params=params,
            shape=cfg.shape, extents=cfg.extents,
            T=cfg.T, nt=cfg.nt, num_snapshots=cfg.snapshots,
            u0=u0, v0=v0,
            u=self._downsample(u_b),
            v=self._downsample(v_b) if v_b is not None else None,
            m=m_b, c=c_b, m_type=m_params.get("type", cfg.m_type),
            m_attrs={f"m_{k}": str(v) for k, v in m_params.items()},
            scalar_series=scal,
            elapsed_time=per_run,
            extra_meta=dict(
                integrator=cfg.integrator, krylov_m=cfg.krylov_m,
                anisotropy_type=c_params.get("type", cfg.anisotropy_type),
                **{f"c_{k}": str(v) for k, v in c_params.items()}))
        return path

    def _archive_run_npy(self, idx, params, c_params, m_params, u0, v0,
                         m_b, c_b, u_b, v_b, scal, per_run):
        """The reference drivers' own trajectory format (util.hpp:37-92
        save_to_npy): one .npy per array + a JSON metadata sidecar, streamed
        through the native async writer when available."""
        cfg = self.cfg
        base = self.h5_dir / f"run_{self.run_id}_{idx:04d}"

        def put(suffix, arr):
            p = base.parent / f"{base.name}_{suffix}.npy"
            arr = np.ascontiguousarray(arr)
            if self._npy_writer is not None:
                self._npy_writer.submit(p, arr)
            else:
                np.save(p, arr)

        put("u", self._downsample(u_b))
        if v_b is not None:
            put("v", self._downsample(v_b))
        put("u0", u0)
        if v0 is not None:
            put("v0", v0)
        put("m", m_b)
        put("c", c_b)
        for name, values in (scal or {}).items():
            put(name, values)
        meta_path = base.parent / f"{base.name}.json"
        meta_path.write_text(json.dumps(dict(
            problem_type=cfg.system, run_id=self.run_id, run_index=idx,
            phenomenon=cfg.phenomenon,
            phenomenon_params={k: str(v) for k, v in params.items()},
            shape=list(cfg.shape), extents=list(cfg.extents),
            T=cfg.T, nt=cfg.nt, num_snapshots=cfg.snapshots,
            integrator=cfg.integrator, krylov_m=cfg.krylov_m,
            m_type=m_params.get("type", cfg.m_type),
            anisotropy_type=c_params.get("type", cfg.anisotropy_type),
            elapsed_time=per_run), indent=2))
        return meta_path

    def _existing_runs(self):
        """Indices of runs already fully archived under this run id (resume
        support). Truncated/corrupt files — a crash mid-write — do not
        count, so their batch re-evolves."""
        cfg = self.cfg
        found = set()
        if cfg.archive_format == "hdf5":
            h5py = io_hdf5.h5py_or_raise()
            for p in self.h5_dir.glob(f"run_{self.run_id}_*.h5"):
                try:
                    idx = int(p.stem.rsplit("_", 1)[1])
                    with h5py.File(p, "r") as f:
                        if "u" in f and "metadata" in f:
                            found.add(idx)
                except (OSError, ValueError):
                    continue
        else:
            # the sidecar is written after the array submissions, but the
            # native writer flushes asynchronously — a crash while it drains
            # can leave ANY companion array truncated with the sidecar
            # intact. Require a loadable header on every array the config
            # archives, not just u.
            suffixes = ["u", "u0", "m", "c"]
            if cfg.family == "realwave":
                suffixes += ["v", "v0"]
            if cfg.guard and cfg.record_energy:
                suffixes.append("mass" if cfg.family == "nlse" else "energy")
            for p in self.h5_dir.glob(f"run_{self.run_id}_*.json"):
                try:
                    idx = int(p.stem.rsplit("_", 1)[1])
                    for sfx in suffixes:
                        np.load(self.h5_dir / f"{p.stem}_{sfx}.npy",
                                mmap_mode="r")
                    found.add(idx)
                except (OSError, ValueError):
                    continue
        return found

    def _archive_flush(self, futures):
        """Resolve archiver futures in submission order; drain the native
        writer so every byte is on disk before run() returns."""
        written = [f.result() for f in futures]
        if self._npy_writer is not None:
            self._npy_writer.flush()
            if self._npy_writer.errors:
                raise RuntimeError(
                    f"native npy writer reported {self._npy_writer.errors} "
                    "failed writes")
        return written

    # -- the sweep ------------------------------------------------------
    def _sweep_summary(self, stats):
        """End-of-sweep farm summary: every process's (walltime, sample_s,
        evolve_s, archived, guard / resume skips) allgathered and ONE line
        printed by process 0, the reference MPI farm's gather of per-rank
        walltimes to rank 0 (submit_nlse.py:129-134). Returns the summary
        string (None on the other processes)."""
        local = np.asarray([stats[k] for k in (
            "wall_s", "sample_s", "evolve_s", "archived", "guard_skipped",
            "resume_skipped")], np.float64)
        allv = dist.process_allgather(local).reshape(self.nproc, local.size)
        if self.pid != 0:
            return None
        wall = allv[:, 0]
        archived = int(allv[:, 3].sum())
        total_runs = self.cfg.num_runs * self.nproc
        line = (f"sweep summary [{self.run_id}]: {self.nproc} host(s), "
                f"{archived}/{total_runs} runs archived "
                f"({int(allv[:, 4].sum())} guard-skipped, "
                f"{int(allv[:, 5].sum())} resume-skipped); "
                f"wall/host min {wall.min():.2f}s max {wall.max():.2f}s "
                f"(sample {allv[:, 1].sum():.2f}s, "
                f"evolve {allv[:, 2].sum():.2f}s summed); "
                f"{archived / max(wall.max(), 1e-9):.2f} runs/s aggregate")
        print(line)
        return line

    def run(self):
        cfg = self.cfg
        futures = []
        done = 0
        stats = dict(wall_s=0.0, sample_s=0.0, evolve_s=0.0, archive_s=0.0,
                     archived=0, guard_skipped=0, resume_skipped=0)
        t_sweep0 = time.time()
        # pad quota: the batch must divide the mesh's batch axis (grid axes
        # shard the grid, not the batch); in a group, this process's share
        # of the global batch axis
        mesh_n = (cfg.mesh.axis_size(cfg.batch_axis)
                  if cfg.mesh is not None
                  and cfg.batch_axis in cfg.mesh.axis_names else 1)
        quota = max(1, mesh_n // self.nproc)

        # plan the batches, then pipeline: dispatch k+1 before fetching k
        plan = []          # (batch, offset into this host's run block)
        off = 0
        left = cfg.num_runs
        while left > 0:
            b = min(cfg.batch_size, left)
            plan.append((b, off))
            off += b
            left -= b

        existing = self._existing_runs() if cfg.resume else None
        if existing:
            print(f"resume: found {len(existing)} archived runs for id "
                  f"{self.run_id}")
        skip_round = None
        if existing is not None:
            skip_round = [all(self.pid * cfg.num_runs + off + b in existing
                              for b in range(bsz)) for bsz, off in plan]
            if self.nproc > 1:
                # every process must evolve a round or none: skip it only
                # if EVERY process has it fully archived
                allv = dist.process_allgather(np.asarray(skip_round, bool))
                skip_round = list(np.all(allv.reshape(self.nproc, len(plan)),
                                         axis=0))

        pending = None     # (batch, base, metas, u0s, v0s, m, c, dev_out, t0)
        for k, item in enumerate(plan + [None]):
            if item is not None:
                batch, off = item
                base = self.pid * cfg.num_runs + off
                # pad by resampling, the extra runs evolved and not
                # archived: they consume sampler draws, so the archived ICs
                # depend on the mesh whenever batch % quota != 0, as JAX's
                pad = (-batch) % quota
                ts0 = time.time()
                metas, u0s, v0s, m, c = self._sample_batch(batch + pad)
                stats["sample_s"] += time.time() - ts0
                if skip_round is not None and skip_round[k]:
                    # fully archived: the sampler draws above kept the RNG
                    # stream aligned; nothing to evolve
                    done += batch
                    stats["resume_skipped"] += batch
                    print(f"resume: runs {base}..{base + batch - 1} already "
                          f"archived, skipping ({done}/{cfg.num_runs})")
                    continue
                t0 = time.time()
                if cfg.family == "nlse":
                    dev_out = self._dispatch_nlse(u0s, m, c)
                else:
                    dev_out = self._dispatch_realwave(u0s, v0s, m, c)
                current = (batch, base, metas, u0s, v0s, m, c, dev_out, t0)
            else:
                current = None
            if pending is None:
                pending = current
                continue
            batch, base, metas, u0s, v0s, m, c, dev_out, t0 = pending
            if cfg.family == "nlse":
                u_traj, bad_at, series = self._fetch_nlse(dev_out)
                v_traj = None
            else:
                u_traj, v_traj, bad_at, series = self._fetch_realwave(
                    dev_out)
            walltime = time.time() - t0
            per_run = walltime / batch
            stats["evolve_s"] += walltime

            for b in range(batch):
                # globally unique run index: host-major blocks, so a sweep's
                # archive is the union of every process's files
                idx = base + b
                if bad_at is not None and bad_at[b] < cfg.snapshots:
                    # flagged ON DEVICE by the in-loop guard; the batch may
                    # have early-exited, so later snapshots can be zeros —
                    # never archive them
                    print(f"run {idx}: non-finite at snapshot "
                          f"{int(bad_at[b])} (in-loop guard), skipping "
                          f"(phenomenon params {metas[b][0]})")
                    stats["guard_skipped"] += 1
                    continue
                if bad_at is None and not np.isfinite(u_traj[b]).all():
                    print(f"run {idx}: non-finite trajectory, skipping "
                          f"(phenomenon params {metas[b][0]})")
                    stats["guard_skipped"] += 1
                    continue
                stats["archived"] += 1
                args = (idx, metas[b], u0s[b], v0s[b], m[b], c[b],
                        u_traj[b],
                        v_traj[b] if v_traj is not None else None,
                        ({k: v[b] for k, v in series.items()}
                         if series else None),
                        per_run)
                if self._archiver is not None:
                    futures.append(self._archiver.submit(
                        self._archive_run, *args))
                else:
                    ta0 = time.time()
                    futures.append(_Done(self._archive_run(*args)))
                    stats["archive_s"] += time.time() - ta0
            done += batch
            # NOTE: with pipelining, a batch's walltime overlaps the next
            # batch's device time (and the first batch includes compile),
            # so batch times can exceed the process' total wall time.
            print(f"batch done: {done}/{cfg.num_runs} runs, "
                  f"{walltime:.2f}s dispatch-to-fetch ({per_run:.2f}s/run, "
                  f"overlapped)")
            pending = current
        ta0 = time.time()
        written = self._archive_flush(futures)
        stats["archive_s"] += time.time() - ta0
        stats["wall_s"] = time.time() - t_sweep0
        self.last_stats = dict(stats)
        self.summary_line = self._sweep_summary(stats)
        return written
