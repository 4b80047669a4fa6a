"""No-flux ghost copy of a planar 3D state (port of
nlsolvers_tpu/ops/pallas/bc3d.py, sharded grids included).

The kernel (`bc3d_kernel` in csrc/lanczos3d.cu) replaces bc3d._bc_call (a
batch of states, the form jax.vmap gives it, in one launch). It
updates the six faces of the (P, R = nz*ny, nx) state IN PLACE, in the
reference's order (boundaries_3d.hpp:8-31: x faces on interior y and z, then
y faces on interior z, then z faces), so it moves the faces' bytes, not the
volume's. On a sharded grid the state is one shard's block: pass the GLOBAL
`global_shape` and the block's `offsets` (z0, y0, x0); which cells are faces
comes from global coordinates, and the sources stay shard-local (local
blocks need at least 2 cells per axis, as parallel/spatial's
sharded_neumann_3d). `bc3d_ref`, its plain version, applies
ops/boundaries.neumann_no_velocity_3d (unsharded) or its block form on
global coordinates, neumann_no_velocity_3d_block, and writes the result
back, also in place. The wrapper launches the kernel for a CUDA tensor under
config.kernel_mode "auto" and raises if it cannot run; a CPU tensor, or
"off", takes the plain version.
"""

import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops.boundaries import (
    neumann_no_velocity_3d, neumann_no_velocity_3d_block)
from nlsolvers_tpu_torch.ops.cuda import lanczos3d
from nlsolvers_tpu_torch.ops.cuda.lanczos2d import _stream
from nlsolvers_tpu_torch.ops.operators import block_coords
from nlsolvers_tpu_torch.utils.profiling import spanned

__all__ = ["neumann_bc_planar_3d", "bc3d_ref", "block_in_grid"]


def _view(up, shape, what):
    nz, ny, nx = shape
    if up.dim() not in (3, 4) or up.shape[-3] not in (1, 2) or tuple(
            up.shape[-2:]) != (nz * ny, nx):
        raise ValueError(f"{what}: state {tuple(up.shape)} is not a planar "
                         f"([B,] 1|2, {nz * ny}, {nx}) view of "
                         f"{tuple(shape)}")
    return up.view(tuple(up.shape[:-2]) + (nz, ny, nx))


def block_in_grid(shape, global_shape, offsets, what):
    """(global shape, offsets) of the block, checked: the block lies inside
    the grid and has at least 2 cells per axis (3 when it is the whole
    axis). 2D or 3D."""
    if global_shape is None:
        global_shape, offsets = tuple(shape), (0,) * len(shape)
    elif offsets is None:
        raise ValueError(f"{what}: a global_shape needs the block's offsets")
    global_shape = tuple(int(g) for g in global_shape)
    offsets = tuple(int(o) for o in offsets)
    if not len(shape) == len(global_shape) == len(offsets):
        raise ValueError(f"{what}: block {tuple(shape)}, grid {global_shape} "
                         f"and offsets {offsets} differ in rank")
    for n, g, o in zip(shape, global_shape, offsets):
        if n < 2 or g < 3 or o < 0 or o + n > g:
            raise ValueError(f"{what}: block {tuple(shape)} at {offsets} of "
                             f"the grid {global_shape} (needs sides >= 2 "
                             f"inside a grid of sides >= 3)")
    return global_shape, offsets


def bc3d_ref(up, shape, global_shape=None, offsets=None):
    """Plain version of neumann_bc_planar_3d (in place; returns up)."""
    v = _view(up, shape, "bc3d_ref")
    if global_shape is None:
        v.copy_(neumann_no_velocity_3d(v))
        return up
    glob, offs = block_in_grid(shape, global_shape, offsets, "bc3d_ref")
    v.copy_(neumann_no_velocity_3d_block(
        v, block_coords(offs, shape, up.device), glob))
    return up


@spanned("nls.launch.neumann_bc_planar_3d")
def neumann_bc_planar_3d(up, shape, global_shape=None, offsets=None):
    """Ghost copy on a planar (P, nz*ny, nx) float32 state of the block
    `shape` = (nz, ny, nx), IN PLACE; returns up. Unsharded the block is the
    grid; on a sharded grid pass global_shape and the block's offsets. A
    block with no cell on the domain's faces is left as it is, and no kernel
    is launched. A batch (B, P, nz*ny, nx) of states (the datagen engine's
    lanes) is one launch; each lane's copy is the unbatched one."""
    if not use_kernel(up):
        return bc3d_ref(up, shape, global_shape, offsets)
    what = "neumann_bc_planar_3d"
    nz, ny, nx = shape
    _view(up, shape, what)
    if up.dtype != torch.float32 or not up.is_contiguous():
        raise ValueError(f"{what}: the state must be a contiguous float32 "
                         f"tensor")
    glob, offs = block_in_grid(shape, global_shape, offsets, what)
    if all(0 < o and o + n < g for n, g, o in zip(shape, glob, offs)):
        return up
    B = up.shape[0] if up.dim() == 4 else 1
    lanczos3d._check(lanczos3d._lib().lz3_bc3d(B, up.shape[-3],
                                               up.data_ptr(), nz, ny, nx,
                                               *offs, *glob, _stream(up)),
                     what)
    neumann_bc_planar_3d.launches += 1
    return up


neumann_bc_planar_3d.launches = 0
