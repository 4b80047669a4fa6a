"""No-flux ghost copy of a planar 3D state (port of
nlsolvers_tpu/ops/pallas/bc3d.py, unsharded).

The kernel (`bc3d_kernel` in csrc/lanczos3d.cu) replaces bc3d._bc_call. It
updates the six faces of the (P, R = nz*ny, nx) state IN PLACE, in the
reference's order (boundaries_3d.hpp:8-31: x faces on interior y and z, then
y faces on interior z, then z faces), so it moves the faces' bytes, not the
volume's. `bc3d_ref`, its plain version, applies
ops/boundaries.neumann_no_velocity_3d and writes the result back, also in
place. The wrapper launches the kernel for a CUDA tensor under
config.kernel_mode "auto" and raises if it cannot run; a CPU tensor, or
"off", takes the plain version.
"""

import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops.boundaries import neumann_no_velocity_3d
from nlsolvers_tpu_torch.ops.cuda import lanczos3d
from nlsolvers_tpu_torch.ops.cuda.lanczos2d import _stream

__all__ = ["neumann_bc_planar_3d", "bc3d_ref"]


def _view(up, shape, what):
    nz, ny, nx = shape
    if up.dim() != 3 or up.shape[0] not in (1, 2) or tuple(
            up.shape[1:]) != (nz * ny, nx):
        raise ValueError(f"{what}: state {tuple(up.shape)} is not a planar "
                         f"(1|2, {nz * ny}, {nx}) view of {tuple(shape)}")
    return up.view(up.shape[0], nz, ny, nx)


def bc3d_ref(up, shape):
    """Plain version of neumann_bc_planar_3d (in place; returns up)."""
    v = _view(up, shape, "bc3d_ref")
    v.copy_(neumann_no_velocity_3d(v))
    return up


def neumann_bc_planar_3d(up, shape):
    """Ghost copy on a planar (P, nz*ny, nx) float32 state of the grid
    `shape` = (nz, ny, nx), IN PLACE; returns up."""
    if not use_kernel(up):
        return bc3d_ref(up, shape)
    nz, ny, nx = shape
    _view(up, shape, "neumann_bc_planar_3d")
    if up.dtype != torch.float32 or not up.is_contiguous():
        raise ValueError("neumann_bc_planar_3d: the state must be a "
                         "contiguous float32 tensor")
    if min(shape) < 3:
        raise ValueError(f"neumann_bc_planar_3d: needs nz, ny, nx >= 3, got "
                         f"{tuple(shape)}")
    lanczos3d._check(lanczos3d._lib().lz3_bc3d(up.shape[0], up.data_ptr(),
                                               nz, ny, nx, _stream(up)),
                     "neumann_bc_planar_3d")
    neumann_bc_planar_3d.launches += 1
    return up


neumann_bc_planar_3d.launches = 0
