"""Sharded state and the collectives of a single-process mesh.

A sharded field is a list of local tensors, one per shard of the mesh in
row-major order (parallel/mesh.py), each contiguous on its shard's device.
The trailing dimensions of a field are the grid, split over the mesh axes
named in `axis_names` (one per grid dimension); leading dimensions, such as
the (re, im) planes of planar state, are not split. `shard` and `gather`
convert at the edges of a run; a sharded step keeps its state sharded, and
only halo slabs and the packed dot partials cross shards.

The collectives are those of JAX's shard_map, written out over the shards:
  recv_from_prev / recv_from_next   lax.ppermute to the next / previous shard
                                    along one axis (spatial.py:53-64); an
                                    edge shard receives zeros, which is the
                                    no-flux boundary condition
  psum / pmax                       lax.psum / lax.pmax: one sum (or max) of
                                    the shards' partials in shard order,
                                    handed to every shard, so all shards see
                                    the same bits
A value moves between shards with Tensor.to, a no-op when both shards sit
on one device. A mesh's batch axis (parallel/mesh.batch_blocks) splits a
batch's lane dimension: `shard` and `gather` take it as `batch_axis`.
"""

import contextlib

import numpy as np
import torch

from nlsolvers_tpu_torch.parallel.mesh import lane_blocks

__all__ = ["local_shape", "offsets", "shard", "gather", "recv_from_prev",
           "recv_from_next", "psum", "pmax", "broadcast", "per_shard"]


def local_shape(global_shape, mesh, axis_names, batch_axis=None):
    """The block each shard holds of a `global_shape` grid whose dimensions
    are split over the mesh axes `axis_names`; `batch_axis` may name one
    more axis, which splits the lanes of a batch, never the grid. Raises
    ValueError when a dimension does not divide over its axis, as
    shard_map does."""
    global_shape, axis_names = tuple(global_shape), tuple(axis_names)
    if len(global_shape) != len(axis_names):
        raise ValueError(f"grid {global_shape} needs one mesh axis per "
                         f"dimension, got {axis_names}")
    for a in axis_names + ((batch_axis,) if batch_axis else ()):
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
    for a, n in zip(mesh.axis_names, mesh.shape):
        if a not in axis_names and a != batch_axis and n > 1:
            raise ValueError(f"mesh axis {a!r} of size {n} splits no grid "
                             f"dimension")
    out = []
    for g, a in zip(global_shape, axis_names):
        n = mesh.axis_size(a)
        if g % n:
            raise ValueError(f"grid dimension {g} is not divisible by the "
                             f"{n} shards of mesh axis {a!r}")
        out.append(g // n)
    return tuple(out)


def offsets(mesh, k, axis_names, lshape):
    """Global index of shard k's first cell along each grid dimension."""
    return tuple(mesh.axis_index(k, a) * n for a, n in zip(axis_names, lshape))


def _block(mesh, k, axis_names, lshape, lanes=None):
    """Shard k's index into a global field; `lanes` (batch_axis, dim, n):
    the n lanes of its batch index along dimension `dim` too."""
    index = (Ellipsis,) + tuple(slice(o, o + n) for o, n in zip(
        offsets(mesh, k, axis_names, lshape), lshape))
    if lanes is None:
        return index
    batch_axis, dim, n = lanes
    b0 = mesh.axis_index(k, batch_axis) * n
    return (slice(None),) * dim + (slice(b0, b0 + n),) + index


def _grid_axes(mesh, axis_names, batch_axis):
    if axis_names is not None:
        return tuple(axis_names)
    return tuple(a for a in mesh.axis_names if a != batch_axis)


def shard(x, mesh, axis_names=None, batch_axis=None, batch_dim=0):
    """A global field (tensor or numpy) as a sharded field: one contiguous
    copy of each shard's block on that shard's device. With `batch_axis`,
    dimension `batch_dim` of x holds the lanes of a batch, split over that
    mesh axis (JAX's P(batch_axis) on it): shard k holds the lanes of its
    batch index."""
    axis_names = _grid_axes(mesh, axis_names, batch_axis)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    lshape = local_shape(x.shape[x.dim() - len(axis_names):], mesh,
                         axis_names, batch_axis)
    lanes = None
    if batch_axis is not None:         # each batch index's lane count
        n = lane_blocks(x.shape[batch_dim], mesh.axis_size(batch_axis))[0]
        lanes = (batch_axis, batch_dim, n.stop)
    return [x[_block(mesh, k, axis_names, lshape, lanes)].to(
        mesh.devices[k], copy=True).contiguous() for k in range(mesh.size)]


def gather(parts, mesh, axis_names=None, batch_axis=None, batch_dim=0):
    """The global field of a sharded field, on the first shard's device
    (`batch_axis`, `batch_dim` as shard takes them)."""
    axis_names = _grid_axes(mesh, axis_names, batch_axis)
    nd = len(axis_names)
    lshape = tuple(parts[0].shape[parts[0].dim() - nd:])
    grid = tuple(n * mesh.axis_size(a) for n, a in zip(lshape, axis_names))
    shape = list(parts[0].shape[:parts[0].dim() - nd]) + list(grid)
    lanes = None
    if batch_axis is not None:
        lanes = (batch_axis, batch_dim, shape[batch_dim])
        shape[batch_dim] *= mesh.axis_size(batch_axis)
    out = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
    for k, p in enumerate(parts):
        out[_block(mesh, k, axis_names, lshape, lanes)] = p.to(out.device)
    return out


def _recv(slabs, mesh, axis_name, step):
    out = []
    for k in range(mesh.size):
        src = mesh.neighbor(k, axis_name, step)
        out.append(torch.zeros_like(slabs[k]) if src is None
                   else slabs[src].to(mesh.devices[k]))
    return out


def recv_from_prev(slabs, mesh, axis_name):
    """Each shard receives its predecessor's slab along `axis_name`; the
    first shard of the axis receives zeros."""
    return _recv(slabs, mesh, axis_name, -1)


def recv_from_next(slabs, mesh, axis_name):
    """Each shard receives its successor's slab along `axis_name`; the last
    shard of the axis receives zeros."""
    return _recv(slabs, mesh, axis_name, 1)


def _reduce(parts, mesh, op):
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return broadcast(acc, mesh)


def psum(parts, mesh):
    """The sum of every shard's partial, in shard order, handed to every
    shard (a list, one copy per shard's device)."""
    return _reduce(parts, mesh, torch.add)


def pmax(parts, mesh):
    """The largest of every shard's partial, handed to every shard."""
    return _reduce(parts, mesh, torch.maximum)


def broadcast(x, mesh):
    """x on every shard's device (a list, one per shard)."""
    return [x.to(d) for d in mesh.devices]


def per_shard(mesh, fn):
    """[fn(k) for every shard k], each call made with its shard's card as
    the current CUDA device: a kernel launches on the current device, so a
    mesh over several cards needs it (over one card it changes nothing)."""
    out = []
    for k, d in enumerate(mesh.devices):
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            out.append(fn(k))
    return out
