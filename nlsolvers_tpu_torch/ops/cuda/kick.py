"""The SS2 step's half phase kick with the no-flux ghost copy folded in.

  phase_kick_bc_planar / kick_bc_ref   replaces bc3d._bc_call (K14) composed
                                       with the phase kick that closes an SS2
                                       step (models/nlse.py
                                       phase_kick_planar, fused by XLA), in 2D
                                       and 3D, on the whole grid or on one
                                       shard's block

On a planar (2, R, nx) float32 state: out = ghost(up * exp(i theta rho(up))),
a NEW tensor (the input is left as it was). A batch (B, 2, R, nx) of
states, each lane with its own m field (the density's m is (B, R, nx)),
takes one launch, the same faces on every lane. `rho` is a planar density from
models/nonlinearities.nlse_density_planar, which carries its kind and m
field for the kernel. `grid=None` is the kick alone (the step's opening
kick, or bc "none"); otherwise `grid` (kick_grid) gives the block's shape,
(ny, nx) or (nz, ny, nx) with R their rows, and on a sharded grid the
GLOBAL shape and the block's offsets: which cells are faces comes from
global coordinates, the sources stay block-local, as in ops/cuda/bc3d.py.

The kernel (`kick_bc_kernel` in csrc/kick.cu) runs for a CUDA tensor under
config.kernel_mode "auto" and raises if it cannot; a CPU tensor, or "off",
takes `kick_bc_ref`: phase_kick_planar, then the ghost copy the SS2 step
ran before the kernel existed (ops/boundaries.neumann_no_velocity_2d or its
block form in 2D, ops/cuda/bc3d.bc3d_ref in 3D).
"""

import ctypes
import math
from dataclasses import dataclass

import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops.boundaries import (neumann_no_velocity_2d,
                                                neumann_no_velocity_2d_block)
from nlsolvers_tpu_torch.ops.cuda import _build
from nlsolvers_tpu_torch.ops.cuda.bc3d import bc3d_ref, block_in_grid
from nlsolvers_tpu_torch.ops.operators import block_coords
from nlsolvers_tpu_torch.utils.profiling import spanned

__all__ = ["KickGrid", "kick_grid", "phase_kick_planar",
           "phase_kick_bc_planar", "kick_bc_ref"]

_KINDS = {"cubic": 0, "cubic_quintic": 1, "saturable": 2}


def phase_kick_planar(up, rho, theta):
    """up * exp(i*theta*rho) on PLANAR state: (re, im) on axis -3, as
    (2, R, nx) or a batch (B, 2, R, nx)."""
    th = theta * rho
    c, s = torch.cos(th), torch.sin(th)
    re, im = up[..., 0, :, :], up[..., 1, :, :]
    return torch.stack([re * c - im * s, re * s + im * c], dim=-3)


@dataclass(frozen=True)
class KickGrid:
    """The block a kick's ghost copy works on: its shape; on a sharded grid
    the global shape and its offsets (None: the block is the grid); and
    `faces` = (zl, zh, yl, yh, xl, xh), 1 where the block holds that face of
    the grid (no z faces in 2D). Made by kick_grid, once per problem."""
    shape: tuple
    global_shape: tuple
    offsets: tuple
    faces: tuple


def kick_grid(shape, global_shape=None, offsets=None):
    """A checked KickGrid: a 2D or 3D block with at least 2 cells per axis
    inside a grid of at least 3 (a whole unsharded axis needs 3)."""
    shape = tuple(int(n) for n in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"kick_grid: shape {shape} is not (ny, nx) or "
                         f"(nz, ny, nx)")
    glob, offs = block_in_grid(shape, global_shape, offsets, "kick_grid")
    faces = [(int(o == 0), int(o + n == g))
             for n, g, o in zip(shape, glob, offs)]
    if len(shape) == 2:
        faces.insert(0, (0, 0))
    faces = tuple(f for lo_hi in faces for f in lo_hi)
    if global_shape is None:
        return KickGrid(shape, None, None, faces)
    return KickGrid(shape, glob, offs, faces)


def kick_bc_ref(up, rho, theta, grid=None):
    """Plain version of phase_kick_bc_planar (returns a new tensor)."""
    out = phase_kick_planar(up, rho(up), theta)
    if grid is None:
        return out
    if len(grid.shape) == 3:
        return bc3d_ref(out, grid.shape, grid.global_shape, grid.offsets)
    if grid.global_shape is None:
        return neumann_no_velocity_2d(out)
    return neumann_no_velocity_2d_block(
        out, block_coords(grid.offsets, grid.shape, up.device),
        grid.global_shape)


_lib_cache = []


def _lib():
    if _lib_cache:
        return _lib_cache[0]
    lib = _build.library("kick")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kick_bc.argtypes = [i32, i32, i32, vp, vp, vp] + [i32] * 9 + [
        f32] * 4 + [vp]
    lib.kick_bc.restype = i32
    lib.kick_error_string.argtypes = [i32]
    lib.kick_error_string.restype = ctypes.c_char_p
    _lib_cache.append(lib)
    return lib


@spanned("nls.kick")
def phase_kick_bc_planar(up, rho, theta, grid=None):
    """ghost(up * exp(i theta rho(up))) on a planar (2, R, nx) float32
    state, or on each lane of a batch (B, 2, R, nx), out of place; `grid`
    None skips the ghost copy."""
    if not use_kernel(up):
        return kick_bc_ref(up, rho, theta, grid)
    what = "phase_kick_bc_planar"
    if (up.dim() not in (3, 4) or up.shape[-3] != 2
            or up.dtype != torch.float32 or not up.is_contiguous()):
        raise ValueError(f"{what}: the state {tuple(up.shape)} {up.dtype} "
                         f"must be a contiguous float32 ([B,] 2, R, nx) "
                         f"tensor")
    kind = _KINDS.get(getattr(rho, "kind", None))
    m = getattr(rho, "m", None)
    if kind is None or not isinstance(m, torch.Tensor):
        raise ValueError(f"{what}: the kernel takes a planar density from "
                         f"nlse_density_planar with an m field")
    R, nx = up.shape[-2:]
    B = up.shape[0] if up.dim() == 4 else 1
    mshape = tuple(up.shape[:-3]) + (R, nx)
    if (tuple(m.shape) != mshape or m.dtype != torch.float32
            or m.device != up.device or not m.is_contiguous()):
        raise ValueError(f"{what}: m {tuple(m.shape)} {m.dtype} on "
                         f"{m.device} must be a contiguous float32 {mshape} "
                         f"tensor on {up.device}")
    if grid is None:
        nz, ny, faces = 1, R, (0,) * 6
    else:
        if math.prod(grid.shape[:-1]) != R or grid.shape[-1] != nx:
            raise ValueError(f"{what}: state {tuple(up.shape)} is not a "
                             f"planar view of the block {grid.shape}")
        nz, ny = ((1, grid.shape[0]) if len(grid.shape) == 2
                  else grid.shape[:2])
        faces = grid.faces
    out = torch.empty_like(up)
    vec = 4 if nx % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (up, m, out)) else 1
    err = _lib().kick_bc(kind, vec, B, up.data_ptr(), m.data_ptr(),
                         out.data_ptr(), nz, ny, nx, *faces, theta,
                         rho.sigma1, rho.sigma2, rho.kappa,
                         torch.cuda.current_stream(up.device).cuda_stream)
    if err != 0:
        msg = _lib().kick_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
    phase_kick_bc_planar.launches += 1
    return out


phase_kick_bc_planar.launches = 0
