"""The device mesh of a grid-sharded run (port of nlsolvers_tpu/parallel/mesh.py).

JAX's shard_map is single-controller: one process drives every shard. The
port keeps that: a `Mesh` is a shape, its axis names and one torch.device per
shard in row-major order, and one process runs every shard's work on its
device. A device may appear more than once, so one card can hold every shard
of a mesh (the kernels then run with real cross-shard halos), or four cards
one shard each.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "factor_devices"]


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
