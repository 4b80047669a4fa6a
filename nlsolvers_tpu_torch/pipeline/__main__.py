"""Datagen CLI: `python -m nlsolvers_tpu_torch.pipeline <family> [options]`.

Port of nlsolvers_tpu/pipeline/__main__.py: the same subcommands and flags,
which mirror the reference launcher argparse surfaces
(complex_launcher_2d.py:276-354, real_launcher_2d.py parse_args), plus
--device (default cuda; cpu only when asked). --shard-batch N splits each
batch over N shards (-1: every visible device; the visible cards taken in
turn, so that several shards may share one, as --shard-grid's do);
--shard-grid gy,gx (gz,gy,gx in 3D) splits each trajectory's grid over
that many shards, all on --device (the grid-sharded engines); both
together make a (batch, *grid) mesh. With NLS_COORDINATOR,
NLS_NUM_PROCESSES and NLS_PROCESS_ID set, every process of the group runs
this CLI (parallel/distributed.py): --num-runs per process, the batch over
every process's devices, archives per process.

Examples:
  python -m nlsolvers_tpu_torch.pipeline nlse --phenomenon multi_soliton \
      --system cubic --nx 256 --T 1.2 --nt 2000 --snapshots 128 \
      --num-runs 8 --batch-size 8 --anisotropy-type layered \
      --m-type piecewise --format npy --output-dir out
  python -m nlsolvers_tpu_torch.pipeline realwave --phenomenon kink_field \
      --system sine_gordon --integrator gautschi --dim 2 --nx 128 \
      --num-runs 2 --output-dir out
  python -m nlsolvers_tpu_torch.pipeline nlse --phenomenon multi_soliton \
      --nx 1024 --T 0.12 --nt 200 --snapshots 5 --num-runs 2 \
      --anisotropy-type layered --shard-grid 2,2 --format npy \
      --output-dir out
  python -m nlsolvers_tpu_torch.pipeline nlse --phenomenon multi_soliton \
      --nx 256 --num-runs 8 --shard-batch 2 --format npy --output-dir out
"""

import argparse
import sys

import numpy as np

import torch

from nlsolvers_tpu_torch.parallel import distributed as dist
from nlsolvers_tpu_torch.parallel.mesh import make_mesh
from nlsolvers_tpu_torch.pipeline.datagen import Datagen, DatagenConfig

NLSE_SYSTEMS = ["cubic", "cubic_quintic", "saturable"]
REALWAVE_SYSTEMS = ["sine_gordon", "double_sine_gordon",
                    "hyperbolic_sine_gordon", "klein_gordon", "phi4",
                    "stochastic_phi4"]
C_TYPES = ["constant", "periodic_structure", "piecewise_constant",
           "sign_changing_mass", "layered", "waveguide", "quasiperiodic",
           "turbulent"]
M_TYPES = ["constant", "piecewise", "gradient", "phase", "topological",
           "defects", "quasiperiodic", "multiscale"]


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m nlsolvers_tpu_torch.pipeline",
        description="Nonlinear-wave trajectory datagen (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="family", required=True)

    def common(sp, systems, default_system, integrators, default_integrator):
        sp.add_argument("--phenomenon", type=str, required=True)
        sp.add_argument("--system", type=str, default=default_system,
                        choices=systems)
        sp.add_argument("--integrator", type=str,
                        default=default_integrator, choices=integrators)
        sp.add_argument("--dim", type=int, default=2, choices=[2, 3])
        sp.add_argument("--nx", type=int, default=128)
        sp.add_argument("--Lx", type=float, default=10.0)
        sp.add_argument("--T", type=float, default=1.5)
        sp.add_argument("--nt", type=int, default=500)
        sp.add_argument("--snapshots", type=int, default=100)
        sp.add_argument("--num-runs", type=int, default=1)
        sp.add_argument("--batch-size", type=int, default=0,
                        help="trajectories per compiled batch "
                             "(0 = all runs in one batch)")
        sp.add_argument("--anisotropy-type", type=str, default="constant",
                        choices=C_TYPES)
        sp.add_argument("--m_type", "--m-type", dest="m_type", type=str,
                        default="constant", choices=M_TYPES)
        sp.add_argument("--m0", type=float, default=1.0)
        sp.add_argument("--krylov-m", type=int, default=0,
                        help="Lanczos subspace size (0 = reference default)")
        sp.add_argument("--dtype", type=str, default="")
        sp.add_argument("--variant", type=str, default="reference",
                        choices=["reference", "clean"])
        sp.add_argument("--dr-target", type=int, default=0,
                        help="downsampled grid points per axis (0 = keep)")
        sp.add_argument("--dr-strategy", type=str, default="interpolation",
                        choices=["FFT", "fft", "interpolation", "none"])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--output-dir", type=str, required=True)
        sp.add_argument("--format", dest="archive_format", type=str,
                        default="hdf5", choices=["hdf5", "npy"],
                        help="archive format: reference-schema HDF5 or the "
                             "device drivers' .npy trajectory files "
                             "(streamed via the native async writer)")
        sp.add_argument("--async-archive", action="store_true",
                        help="archive on background Python threads "
                             "(measured slower for hdf5 — h5py GIL "
                             "contention with D2H; the npy format is "
                             "natively async either way)")
        sp.add_argument("--no-guard", action="store_true",
                        help="disable the in-loop stability guard "
                             "(on-device per-snapshot finiteness check with "
                             "early exit once every run in a batch "
                             "diverged)")
        sp.add_argument("--resume", action="store_true",
                        help="resumable sweep: derive the run id from "
                             "--seed and skip batches whose runs are all "
                             "already archived (same seed => identical "
                             "remaining runs); launch with --resume from "
                             "the start to make a sweep resumable")
        sp.add_argument("--record-energy", action="store_true",
                        help="record mass (NLSE) / discrete energy "
                             "(realwave) per snapshot ON DEVICE during "
                             "generation; archived under energy/")
        sp.add_argument("--shard-batch", type=int, default=0,
                        help="shard the trajectory batch over this many "
                             "shards (-1 = every visible device, 0 = off), "
                             "the visible devices taken in turn; the "
                             "replacement for SLURM-array farming")
        sp.add_argument("--shard-grid", type=str, default="",
                        help="spatial mesh shape for grid sharding (2D: "
                             "'gy,gx' e.g. 2,4; 3D: 'gz,gy,gx'): shard "
                             "EACH trajectory's grid over that many shards "
                             "on --device. Combine with --shard-batch N "
                             "for a (batch, *grid) mesh")
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device of the engine (default cuda; "
                             "cpu only when asked)")

    nlse = sub.add_parser("nlse", help="complex NLSE family")
    common(nlse, NLSE_SYSTEMS, "cubic",
           ["ss2", "sewi", "sewi_fused", "gautschi"], "ss2")
    nlse.add_argument("--sigma1", type=float, default=1.0)
    nlse.add_argument("--sigma2", type=float, default=-0.1)
    nlse.add_argument("--kappa", type=float, default=1.0)
    nlse.add_argument("--no-normalize-ic", action="store_true")
    nlse.add_argument("--bc", type=str, default="noflux",
                      choices=["noflux", "radiating", "none"],
                      help="boundary condition; 'radiating' is the "
                           "experimental radiating envelope "
                           "(boundaries.hpp:59-121, 2D only)")

    rw = sub.add_parser("realwave", help="real wave family (SG/KG/phi4)")
    common(rw, REALWAVE_SYSTEMS, "sine_gordon", ["gautschi", "sv"],
           "gautschi")
    rw.add_argument("--noise-strength", type=float, default=0.1)
    return p


def _visible(device):
    """The devices a CLI mesh takes: every visible card for a CUDA
    --device, the CPU for --device cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(f"--device {device}: torch sees no CUDA "
                               f"device")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev]


def _build_mesh(shard_batch, shard_grid, dim, device):
    """Mesh from the CLI sharding flags (JAX's _build_mesh,
    nlsolvers_tpu/pipeline/__main__.py:140-163): batch-only, grid-only
    (left to Datagen) or a combined (batch, *grid) mesh. -1 takes every
    visible device (over the grid's shards for a combined mesh); the
    shards take the visible devices in turn, so a count above them puts
    several shards on one device."""
    if not shard_batch:
        return None     # none, or grid-only: Datagen builds it
    devices = _visible(device)
    grid_n = int(np.prod(shard_grid)) if shard_grid else 1
    n = shard_batch if shard_batch > 0 else max(1, len(devices) // grid_n)
    total = n * grid_n
    picked = [devices[i % len(devices)] for i in range(total)]
    if not shard_grid:
        return make_mesh(("batch",), shape=(n,), devices=picked)
    axes = (("batch", "gy", "gx") if dim == 2
            else ("batch", "gz", "gy", "gx"))
    return make_mesh(axes, shape=(n,) + tuple(shard_grid), devices=picked)


def config_from_args(args):
    shard_grid = (tuple(int(x) for x in args.shard_grid.split(","))
                  if args.shard_grid else ())
    kwargs = dict(
        family=args.family, phenomenon=args.phenomenon, system=args.system,
        dim=args.dim, nx=args.nx, Lx=args.Lx, T=args.T, nt=args.nt,
        snapshots=args.snapshots, num_runs=args.num_runs,
        batch_size=args.batch_size, integrator=args.integrator,
        anisotropy_type=args.anisotropy_type, m_type=args.m_type,
        m0=args.m0, krylov_m=args.krylov_m, dtype=args.dtype,
        variant=args.variant, dr_target=args.dr_target,
        dr_strategy=args.dr_strategy, seed=args.seed,
        output_dir=args.output_dir, guard=not args.no_guard,
        record_energy=args.record_energy,
        archive_format=args.archive_format,
        archive_async=args.async_archive, resume=args.resume,
        shard_grid=shard_grid, device=args.device,
        mesh=_build_mesh(args.shard_batch, shard_grid, args.dim,
                         args.device))
    if args.family == "nlse":
        kwargs.update(sigma1=args.sigma1, sigma2=args.sigma2,
                      kappa=args.kappa,
                      normalize_ic=not args.no_normalize_ic,
                      boundary=args.bc)
    else:
        kwargs.update(noise_strength=args.noise_strength)
    return DatagenConfig(**kwargs)


def main(argv=None):
    # In a process group (NLS_COORDINATOR / NLS_NUM_PROCESSES /
    # NLS_PROCESS_ID set) every process runs this same CLI and the batch
    # axis spans every process's devices: --num-runs is per process, the
    # archives per process.
    args = build_parser().parse_args(argv)
    joined = dist.initialize_from_env(
        platform="cpu" if torch.device(args.device).type == "cpu" else None)
    try:
        cfg = config_from_args(args)
        if joined and not cfg.shard_grid:
            # with --shard-grid Datagen builds the (nproc, *grid) mesh
            cfg.mesh = dist.global_mesh(("batch",))
        written = Datagen(cfg).run()
    finally:
        if joined:
            dist.shutdown()
    print(f"wrote {len(written)} archives under "
          f"{cfg.output_dir}/{cfg.archive_format}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
