"""The device mesh of a grid-sharded run (port of nlsolvers_tpu/parallel/mesh.py).

JAX's shard_map is single-controller: one process drives every shard. The
port keeps that: a `Mesh` is a shape, its axis names and one torch.device per
shard in row-major order, and one process runs every shard's work on its
device. A device may appear more than once, so one card can hold every shard
of a mesh (the kernels then run with real cross-shard halos), or four cards
one shard each.

A mesh axis that splits no grid dimension is a batch axis (JAX's
P(batch_axis, ...)): it splits the lanes of a trajectory batch. A mesh
(batch, *grid) is n_b grid sub-meshes, one per batch index
(`batch_blocks`), and lane block b (`lane_blocks`) runs on sub-mesh b;
nothing crosses the batch axis, as under shard_map, so halos and psums stay
within a sub-mesh.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "factor_devices", "batch_blocks",
           "lane_blocks"]


def factor_devices(n, dims=3):
    """Factor n devices into a near-balanced tuple, largest axis first."""
    shape = [1] * dims
    remaining = n
    i = 0
    while remaining > 1:
        # peel the smallest prime factor
        for p in range(2, remaining + 1):
            if remaining % p == 0:
                break
        shape[i % dims] *= p
        remaining //= p
        i += 1
    shape.sort(reverse=True)
    return tuple(shape)


@dataclass(frozen=True)
class Mesh:
    """shape: shards per axis; axis_names: one name per axis; devices: one
    torch.device per shard, row-major over the axes (shard k sits at
    np.unravel_index(k, shape))."""
    shape: tuple
    axis_names: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self):
        return len(self.devices)

    def axis_size(self, name):
        return self.shape[self.axis_names.index(name)]

    def coords(self, k):
        """Shard k's index along every axis."""
        return tuple(int(c) for c in np.unravel_index(k, self.shape))

    def axis_index(self, k, name):
        """Shard k's index along axis `name` (lax.axis_index)."""
        return self.coords(k)[self.axis_names.index(name)]

    def neighbor(self, k, name, step):
        """The shard `step` places from shard k along axis `name`, or None
        past the mesh's edge (no wraparound)."""
        c = list(self.coords(k))
        a = self.axis_names.index(name)
        c[a] += step
        if not 0 <= c[a] < self.shape[a]:
            return None
        return int(np.ravel_multi_index(c, self.shape))


def make_mesh(axis_names=("batch", "gy", "gx"), shape=None, devices=None):
    """A Mesh over `devices` (torch.device or strings), one per shard;
    None means every visible CUDA device, and without one this raises
    (nothing moves to the CPU). If `shape` is None the device count is
    auto-factored over the axes, as the JAX package does."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass `devices` "
                               "to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if shape is None:
        shape = factor_devices(len(devices), dims=len(axis_names))
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names), devices)


def batch_blocks(mesh, batch_axis):
    """The mesh cut along `batch_axis`: for each batch index b, (the
    sub-mesh over the other axes whose devices are the shards at index b,
    the indices of those shards in `mesh`), the shards in row-major order
    as np.unravel_index gives them. batch_axis None: one block, the mesh
    itself."""
    if batch_axis is None:
        return [(mesh, tuple(range(mesh.size)))]
    if batch_axis not in mesh.axis_names:
        raise ValueError(f"batch axis {batch_axis!r} is not an axis of the "
                         f"mesh {mesh.axis_names}")
    a = mesh.axis_names.index(batch_axis)
    names = mesh.axis_names[:a] + mesh.axis_names[a + 1:]
    shape = mesh.shape[:a] + mesh.shape[a + 1:]
    out = []
    for b in range(mesh.shape[a]):
        ks = tuple(k for k in range(mesh.size) if mesh.coords(k)[a] == b)
        out.append((Mesh(shape, names, tuple(mesh.devices[k] for k in ks)),
                    ks))
    return out


def lane_blocks(B, n_b):
    """The lanes [b*B/n_b, (b+1)*B/n_b) of each of n_b batch indices, as
    slices. Raises JAX's ValueError when n_b does not divide B."""
    if B % n_b:
        raise ValueError(f"the batch of {B} lanes is not divisible by the "
                         f"{n_b} shards of the mesh's batch axis")
    n = B // n_b
    return [slice(b * n, (b + 1) * n) for b in range(n_b)]
