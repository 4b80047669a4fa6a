"""Multi-process runtime (port of nlsolvers_tpu/parallel/distributed.py).

The reference farms trajectories over hosts with mpi4py: rank 0 makes the
run id, every rank samples its own ICs and runs its own trajectories, and
walltimes are gathered back (submit_nlse.py:80-137); SLURM job arrays do
the same at a coarser grain. The JAX package replaces the farm with one
SPMD process group whose global mesh puts the batch axis host-major, so
that each host samples, steps and archives only the rows of the batch that
land on its own devices and the trajectory program needs no traffic
between hosts.

The port keeps that layout with one process per host. `initialize` joins
the processes into a torch.distributed group on the gloo backend, which
carries only the host-side collectives of a sweep (the summary's
allgather, the resume vote: `process_allgather`). A global mesh
(`global_mesh`) is the JAX package's, the batch axis first and host-major;
its devices are every process's local devices in process order, those of
another process only names here. Each process drives its own part of it,
`local_mesh`: the host-major block of the global batch, rows
[pid*b_local, (pid+1)*b_local), on a single-process mesh of its own
devices. `make_global_batch`, `local_shards` and `host_batch_block` keep
the JAX package's view of a global batch-sharded array: a `GlobalArray`
holds the global shape and this process's shards, each with its global
index. Without a group (`process_count() == 1`) all of this is the one
process's.

The same code runs a local multi-process CPU cluster for testing
(coordinator on localhost, platform "cpu"): tests/test_torch_multihost.py.
"""

import os
from collections import namedtuple
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

from nlsolvers_tpu_torch.parallel.mesh import Mesh, batch_blocks, lane_blocks

__all__ = ["initialize_from_env", "initialize", "shutdown", "process_count",
           "process_index", "local_devices", "global_mesh", "local_mesh",
           "make_global_batch", "local_shards", "host_batch_block",
           "process_seed", "process_allgather", "GlobalArray", "Shard",
           "ENV_COORD", "ENV_NPROCS", "ENV_PID"]

ENV_COORD = "NLS_COORDINATOR"
ENV_NPROCS = "NLS_NUM_PROCESSES"
ENV_PID = "NLS_PROCESS_ID"

# this process's devices, set by initialize (None: every visible card)
_LOCAL_DEVICES = None

# how long joining the group may take before initialize raises
_JOIN_TIMEOUT = timedelta(seconds=300)


def initialize(coordinator, num_processes, process_id,
               local_device_ids=None, platform=None):
    """Join this process into a torch.distributed group (gloo backend) at
    `coordinator` ("host:port", the address process 0 listens on).

    The process's own devices: with platform "cpu", len(local_device_ids)
    CPU devices (one without ids; a device may repeat in a mesh); else the
    cards `local_device_ids`, or every visible card. A group that cannot
    be joined within five minutes raises: nothing carries on as one
    process."""
    import torch.distributed as tdist

    global _LOCAL_DEVICES
    if tdist.is_initialized():
        raise RuntimeError("initialize: this process is already in a group")
    if platform == "cpu":
        _LOCAL_DEVICES = [torch.device("cpu")] * len(local_device_ids or [0])
    elif local_device_ids is not None:
        _LOCAL_DEVICES = [torch.device("cuda", int(i))
                          for i in local_device_ids]
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_JOIN_TIMEOUT)


def initialize_from_env(platform=None):
    """Initialize from the NLS_* environment variables if present; no-op
    otherwise. Returns True when a multi-process group was joined. Set
        NLS_COORDINATOR=host:port  NLS_NUM_PROCESSES=N  NLS_PROCESS_ID=i
    on every process (the same variables as the JAX package's).
    `platform` as initialize takes it."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    initialize(coord, os.environ[ENV_NPROCS], os.environ[ENV_PID],
               platform=platform)
    return True


def shutdown():
    """Leave the process group, if this process joined one."""
    import torch.distributed as tdist

    global _LOCAL_DEVICES
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _LOCAL_DEVICES = None


def _group():
    import torch.distributed as tdist

    return tdist if tdist.is_available() and tdist.is_initialized() else None


def process_count():
    """The number of processes of the group (1 without one)."""
    g = _group()
    return 1 if g is None else g.get_world_size()


def _rank():
    g = _group()
    return 0 if g is None else g.get_rank()


def process_index():
    """This process's index in the group (0 without one)."""
    return _rank()


def local_devices():
    """This process's devices: initialize's, else every visible card (and
    without one this raises: nothing moves to the CPU unless asked)."""
    if _LOCAL_DEVICES is not None:
        return list(_LOCAL_DEVICES)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("local_devices: no CUDA device; initialize with "
                           "platform='cpu' to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def global_mesh(axis_names=("batch",), shape=None):
    """A mesh over every process's devices (every process builds the same
    one), host-major: process p's devices (local_devices(), the same count
    on every process) follow process p-1's, so with the batch axis first,
    contiguous batch blocks live on one process and the trajectory program
    crosses no process. Default shape: one flat batch axis over all of
    them."""
    everyone = local_devices() * process_count()
    if shape is None:
        shape = (len(everyone),) + (1,) * (len(axis_names) - 1)
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names),
                tuple(torch.device(d) for d in everyone))


def local_mesh(mesh, batch_axis="batch"):
    """This process's part of a global mesh: the batch indices
    [pid*n, (pid+1)*n) of its leading batch axis (n its size over the
    process count), with the other axes whole, over this process's
    devices."""
    nproc, pid = process_count(), process_index()
    if mesh.axis_names[0] != batch_axis:
        raise ValueError(f"a global mesh leads with the batch axis "
                         f"{batch_axis!r}, got {mesh.axis_names}")
    n_b = mesh.shape[0]
    if n_b % nproc:
        raise ValueError(f"the batch axis of {n_b} does not divide over "
                         f"{nproc} processes")
    per = mesh.size // nproc
    return Mesh((n_b // nproc,) + mesh.shape[1:], mesh.axis_names,
                mesh.devices[pid * per:(pid + 1) * per])


Shard = namedtuple("Shard", ["index", "data"])


@dataclass
class GlobalArray:
    """This process's view of a global array sharded over a mesh, as a
    jax.Array's: `shape` the global shape, `addressable_shards` this
    process's Shard(index, data), index a tuple of global slices, one per
    dimension, data the block on its shard's device."""
    shape: tuple
    addressable_shards: list

    @property
    def dtype(self):
        return self.addressable_shards[0].data.dtype


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_global_batch(mesh, local_data, batch_axis="batch"):
    """A global batch-sharded array from this process's (B_local, ...)
    block: the global (B_local * nprocs, ...) array, its axis 0 split over
    `batch_axis` host-major and every other mesh axis replicating it (JAX's
    P(batch_axis) with make_array_from_process_local_data). Returns a
    GlobalArray of this process's shards."""
    if not isinstance(local_data, torch.Tensor):
        local_data = torch.from_numpy(np.array(local_data))
    nproc, pid = process_count(), process_index()
    local = local_mesh(mesh, batch_axis) if nproc > 1 else mesh
    b_local = local_data.shape[0]
    out = []
    for (_, ks), rows in zip(batch_blocks(local, batch_axis),
                             lane_blocks(b_local,
                                         local.axis_size(batch_axis))):
        index = (slice(pid * b_local + rows.start, pid * b_local + rows.stop),
                 ) + (slice(None),) * (local_data.dim() - 1)
        for k in ks:
            out.append(Shard(index, local_data[rows].to(local.devices[k],
                                                        copy=True)))
    return GlobalArray((b_local * nproc,) + tuple(local_data.shape[1:]), out)


def local_shards(arr, axis=0):
    """This process's shards of a global array as host numpy blocks.

    Returns a list of (global_start, block) sorted by position along
    `axis`; concatenating the blocks gives this host's contiguous data when
    the batch axis is host-major (global_mesh). Replicated shards appear
    once per copy, as in the JAX package. No collective."""
    out = []
    for s in arr.addressable_shards:
        idx = s.index[axis]
        start = idx.start or 0
        out.append((start, _numpy(s.data)))
    out.sort(key=lambda t: t[0])
    return out


def host_batch_block(arr, nproc, pid):
    """This host's host-major (b_local, ...) block of a global array whose
    axis 0 (batch) is sharded host-major and whose remaining axes may also
    be sharded over this host's devices (grid sharding), assembled from the
    shards' global indices. No collective.

    Returns (block, rows): block (b_local, ...) numpy, rows the global batch
    indices [pid*b_local, (pid+1)*b_local)."""
    b_local = arr.shape[0] // max(nproc, 1)
    start = pid * b_local
    out = np.empty((b_local,) + tuple(arr.shape[1:]),
                   _numpy(arr.addressable_shards[0].data[:0]).dtype)
    covered = np.zeros(out.shape, bool)
    for sh in arr.addressable_shards:
        idx = tuple(sh.index)
        bs = idx[0] if idx else slice(None)
        b0 = bs.start or 0
        b1 = arr.shape[0] if bs.stop is None else bs.stop
        lo, hi = max(b0, start), min(b1, start + b_local)
        if lo >= hi:
            continue
        data = _numpy(sh.data)
        dst = (slice(lo - start, hi - start),) + idx[1:]
        out[dst] = data[lo - b0:hi - b0]
        covered[dst] = True
    if not covered.all():
        raise RuntimeError(
            f"host {pid}: addressable shards do not cover batch rows "
            f"[{start}, {start + b_local}) — non-host-major mesh?")
    return out, np.arange(start, start + b_local)


def process_seed(seed, process_index=None):
    """Per-host RNG seed sequence, SeedSequence(seed).spawn keyed by the
    process (this one's by default): the JAX package's stream for the same
    (seed, process), as the reference seeds each SLURM array task with its
    job id (nlse_2d_launch.sh:68)."""
    pid = _rank() if process_index is None else process_index
    return np.random.SeedSequence(seed).spawn(pid + 1)[pid]


def process_allgather(x):
    """Every process's copy of the numpy array x stacked on a new leading
    axis, in process order (jax.experimental.multihost_utils'
    process_allgather), over the gloo group; x[None] without a group."""
    x = np.asarray(x)
    g = _group()
    if g is None:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x.astype(np.float64)))
    out = [torch.empty_like(t) for _ in range(g.get_world_size())]
    g.all_gather(out, t)
    return torch.stack(out).numpy().astype(x.dtype)
