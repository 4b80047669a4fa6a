"""Matrix-free no-flux Laplacians in 2D and 3D.

Port of nlsolvers_tpu/ops/operators.py.

`laplacian_2d` reproduces the reference's `build_laplacian_noflux`
(laplacians.hpp:10-52): diagonal -4 inside and -3 on the whole boundary ring,
corners included (`variant="reference"`), or -(number of neighbours)
(`variant="clean"`).

`laplacian_3d` reproduces `build_laplacian_noflux_3d` (laplacians.hpp:
105-156) with its y-seam: the y-neighbour loop couples flat indices i and
i + (nx+2) for all i, which links the last y-row of each z-plane to the first
y-row of the next. It is expressed exactly by taking the y-neighbour sum over
the merged (nz*ny, nx) view. `variant="clean"` drops the seam and uses
diagonal -(number of neighbours).

`anisotropic_laplacian_3d` reproduces the finite-volume div(c grad u)
builder (laplacians.hpp:158-218): face coupling = mean of the two cells'
c, diagonal = minus the sum of the row's couplings, with the same y-seam
under `variant="reference"`.

Operators are closures `apply(u) -> Lu` on fields shaped (..., ny, nx) or
(..., nz, ny, nx); leading axes are batch axes. Each carries `kernel_desc`,
the descriptor the Krylov dispatch reads (ops/krylov._fused_path ->
ops/cuda/lanczos2d, lanczos3d). The operators and their tensors live on
`device`, the card unless the caller asks for the CPU.

The 2D anisotropic, separated and biharmonic operators are not ported yet
(ROADMAP.md queue 1, items 2 and 7).
"""

import numpy as np
import torch

__all__ = ["laplacian_2d", "laplacian_3d", "anisotropic_laplacian_3d",
           "neighbor_sum"]


def neighbor_sum(u, dim):
    """Sum of the existing (non-wrapping) neighbours along one dimension:
    cell i receives u[i-1] + u[i+1] where those exist, 0 otherwise."""
    n = u.shape[dim]
    z = torch.zeros_like(u.narrow(dim, 0, 1))
    fwd = torch.cat([u.narrow(dim, 1, n - 1), z], dim=dim)
    bwd = torch.cat([z, u.narrow(dim, 0, n - 1)], dim=dim)
    return fwd + bwd


def _diagonal_2d(ny, nx, variant):
    ring = torch.zeros((ny, nx), dtype=torch.float64)
    ring[0, :] = ring[-1, :] = 1.0
    ring[:, 0] = ring[:, -1] = 1.0
    if variant == "reference":
        return -4.0 + ring
    if variant == "clean":
        cnt = torch.full((ny, nx), 4.0, dtype=torch.float64)
        cnt[0, :] -= 1.0
        cnt[-1, :] -= 1.0
        cnt[:, 0] -= 1.0
        cnt[:, -1] -= 1.0
        return -cnt
    raise ValueError(f"unknown variant {variant!r}")


def _boundary_mask_3d(nz, ny, nx):
    m = torch.zeros((nz, ny, nx), dtype=torch.float64)
    m[0], m[-1] = 1.0, 1.0
    m[:, 0, :] = m[:, -1, :] = 1.0
    m[:, :, 0] = m[:, :, -1] = 1.0
    return m


def _neighbor_count_3d(nz, ny, nx):
    c = torch.full((nz, ny, nx), 6.0, dtype=torch.float64)
    for dim, n in ((0, nz), (1, ny), (2, nx)):
        c.select(dim, 0).sub_(1.0)
        c.select(dim, n - 1).sub_(1.0)
    return c


def laplacian_2d(shape, dx, dy, variant="reference", dtype=torch.float32,
                 device="cuda"):
    """Matrix-free 5-point no-flux Laplacian on an (ny, nx) grid."""
    ny, nx = shape
    diag = _diagonal_2d(ny, nx, variant).to(device=device, dtype=dtype)
    scale = 1.0 / (dx * dy)

    def apply(u):
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    apply.kernel_desc = dict(kind="laplacian_2d", ny=int(ny), nx=int(nx),
                             scale=float(scale), sign=1.0, variant=variant)
    return apply


def laplacian_3d(shape, dx, variant="reference", dtype=torch.float32,
                 device="cuda"):
    """Matrix-free 7-point no-flux Laplacian on an (nz, ny, nx) grid, scaled
    1/dx^2, with the reference's y-seam under variant="reference"."""
    nz, ny, nx = shape
    if variant == "reference":
        diag = -6.0 + _boundary_mask_3d(nz, ny, nx)  # -5 anywhere on boundary
    elif variant == "clean":
        diag = -_neighbor_count_3d(nz, ny, nx)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    diag = diag.to(device=device, dtype=dtype)
    scale = 1.0 / (dx * dx)

    def apply(u):
        batch = u.shape[:-3]
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -3)
        if variant == "reference":
            v = u.reshape(batch + (nz * ny, nx))
            nb = nb + neighbor_sum(v, -2).reshape(u.shape)
        else:
            nb = nb + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    apply.kernel_desc = dict(kind="laplacian_3d", nz=int(nz), ny=int(ny),
                             nx=int(nx), scale=float(scale), sign=1.0,
                             variant=variant)
    return apply


def anisotropic_laplacian_3d(c, dx, variant="reference", device="cuda"):
    """Finite-volume div(c grad u) on an (nz, ny, nx) grid, scaled 1/dx^2.

    `c` (numpy or tensor, (nz, ny, nx)) keeps its dtype for `apply`. The
    descriptor carries the face weights zero-padded to the merged
    (nz*ny, nx) row view as float32 tensors on `device`: wx pads column
    nx-1, wy the rows without a +y face (the last merged row under
    "reference", whose other rows are the y-seam couplings; each plane's
    last row under "clean"), wz the last plane.
    """
    if not isinstance(c, torch.Tensor):
        c = torch.from_numpy(np.array(c))
    c = c.to(device)
    nz, ny, nx = c.shape
    R = nz * ny
    scale = 1.0 / (dx * dx)
    cm = c.reshape(R, nx)
    wx = 0.5 * (c[:, :, :-1] + c[:, :, 1:])
    wz = 0.5 * (c[:-1] + c[1:])
    if variant == "reference":
        wy = 0.5 * (cm[:-1] + cm[1:])                 # merged rows
    elif variant == "clean":
        wy = 0.5 * (c[:, :-1, :] + c[:, 1:, :])
    else:
        raise ValueError(f"unknown variant {variant!r}")

    def apply(u):
        out = torch.zeros(u.shape[:-3] + (nz, ny, nx),
                          dtype=torch.result_type(u, wx), device=u.device)
        fx = wx * (u[..., :, :, 1:] - u[..., :, :, :-1])
        out[..., :, :, :-1] += fx
        out[..., :, :, 1:] -= fx
        fz = wz * (u[..., 1:, :, :] - u[..., :-1, :, :])
        out[..., :-1, :, :] += fz
        out[..., 1:, :, :] -= fz
        if variant == "reference":
            um = u.reshape(u.shape[:-3] + (R, nx))
            om = out.view(out.shape[:-3] + (R, nx))
            fy = wy * (um[..., 1:, :] - um[..., :-1, :])
            om[..., :-1, :] += fy
            om[..., 1:, :] -= fy
        else:
            fy = wy * (u[..., :, 1:, :] - u[..., :, :-1, :])
            out[..., :, :-1, :] += fy
            out[..., :, 1:, :] -= fy
        return out * scale

    f32 = dict(dtype=torch.float32, device=c.device)
    wx_pad = torch.zeros((R, nx), **f32)
    wx_pad[:, :nx - 1] = wx.reshape(R, nx - 1)
    wy_pad = torch.zeros((R, nx), **f32)
    if variant == "reference":
        wy_pad[:R - 1] = wy
    else:
        wy_pad.view(nz, ny, nx)[:, :ny - 1] = wy
    wz_pad = torch.zeros((R, nx), **f32)
    wz_pad[:R - ny] = wz.reshape(R - ny, nx)
    apply.kernel_desc = dict(kind="aniso_laplacian_3d", nz=int(nz),
                             ny=int(ny), nx=int(nx), scale=float(scale),
                             sign=1.0, variant="aniso", wx=wx_pad, wy=wy_pad,
                             wz=wz_pad)
    return apply
