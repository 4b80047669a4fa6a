"""Matrix-free 5-point no-flux Laplacian.

Port of nlsolvers_tpu/ops/operators.py.

`laplacian_2d` reproduces the reference's `build_laplacian_noflux`
(laplacians.hpp:10-52): diagonal -4 inside and -3 on the whole boundary ring,
corners included (`variant="reference"`), or -(number of neighbours)
(`variant="clean"`). Operators are closures `apply(u) -> Lu` on fields shaped
(..., ny, nx); leading axes are batch axes.

The anisotropic, 3D, separated and biharmonic operators are not ported yet
(ROADMAP.md queue 1, item 2).
"""

import torch

__all__ = ["laplacian_2d", "neighbor_sum"]


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


def laplacian_2d(shape, dx, dy, variant="reference", dtype=torch.float32,
                 device="cpu"):
    """Matrix-free 5-point no-flux Laplacian on an (ny, nx) grid.

    The closure carries `kernel_desc`, the static descriptor the Krylov
    dispatch reads (ops/krylov._fused_path -> ops/cuda/lanczos2d).
    """
    ny, nx = shape
    diag = _diagonal_2d(ny, nx, variant).to(device=device, dtype=dtype)
    scale = 1.0 / (dx * dy)

    def apply(u):
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    apply.kernel_desc = dict(kind="laplacian_2d", ny=int(ny), nx=int(nx),
                             scale=float(scale), sign=1.0, variant=variant)
    return apply
