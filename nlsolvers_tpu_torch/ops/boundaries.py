"""No-flux ghost copies in 2D and 3D (port of nlsolvers_tpu/ops/boundaries.py).

The update order of the reference is kept, since it decides the edges and
corners:
2D (boundaries.hpp:41-57): first the two x-edge rows over interior columns,
then the two full y-edge columns, which also set the corners.
3D (boundaries_3d.hpp:8-31): x faces over interior (y, z), then y faces over
interior z and all x, then z faces over all (x, y).
The experimental radiating envelope BC of the NLSE (boundaries.hpp:59-121)
works on complex 2D fields only.
"""

import torch

__all__ = ["neumann_no_velocity_2d", "neumann_no_velocity_2d_block",
           "neumann_no_velocity_3d", "neumann_no_velocity_3d_block",
           "radiating_nlse_2d"]


def neumann_no_velocity_2d(u):
    """u-only ghost copy on (..., ny, nx); returns a new tensor."""
    u = u.clone()
    u[..., 0, 1:-1] = u[..., 1, 1:-1]
    u[..., -1, 1:-1] = u[..., -2, 1:-1]
    u[..., :, 0] = u[..., :, 1]
    u[..., :, -1] = u[..., :, -2]
    return u


def neumann_no_velocity_2d_block(u, coords, dims):
    """neumann_no_velocity_2d on one (..., ny, nx) block of a grid of
    `dims`, by where-masks: which cells are edges comes from the block's
    global coordinates `coords` (gy, gx, index tensors broadcastable to the
    block), the sources stay block-local, so a block needs at least 2 rows
    and columns. The order is neumann_no_velocity_2d's: edge rows over
    interior global columns, then the full edge columns. Returns a new
    tensor."""
    (gy, gx), (NY, NX) = coords, dims
    interior_x = (gx >= 1) & (gx <= NX - 2)
    u = torch.where((gy == 0) & interior_x, u[..., 1:2, :], u)
    u = torch.where((gy == NY - 1) & interior_x, u[..., -2:-1, :], u)
    u = torch.where(gx == 0, u[..., :, 1:2], u)
    return torch.where(gx == NX - 1, u[..., :, -2:-1], u)


def neumann_no_velocity_3d(u):
    """6-face ghost copy on (..., nz, ny, nx); returns a new tensor."""
    u = u.clone()
    # x faces, interior y and z only
    u[..., 1:-1, 1:-1, 0] = u[..., 1:-1, 1:-1, 1]
    u[..., 1:-1, 1:-1, -1] = u[..., 1:-1, 1:-1, -2]
    # y faces, interior z, all x
    u[..., 1:-1, 0, :] = u[..., 1:-1, 1, :]
    u[..., 1:-1, -1, :] = u[..., 1:-1, -2, :]
    # z faces, all x and y
    u[..., 0, :, :] = u[..., 1, :, :]
    u[..., -1, :, :] = u[..., -2, :, :]
    return u


def neumann_no_velocity_3d_block(u, coords, dims):
    """neumann_no_velocity_3d on one (..., nz, ny, nx) block of a grid of
    `dims`, by where-masks: which cells are faces comes from the block's
    global coordinates `coords` (gz, gy, gx, index tensors broadcastable to
    the block), the sources stay block-local, so a block needs at least 2
    cells per axis. The order is neumann_no_velocity_3d's. Returns a new
    tensor."""
    (gz, gy, gx), (NZ, NY, NX) = coords, dims
    int_z = (gz >= 1) & (gz <= NZ - 2)
    int_y = (gy >= 1) & (gy <= NY - 2)
    u = torch.where((gx == 0) & int_y & int_z, u[..., :, :, 1:2], u)
    u = torch.where((gx == NX - 1) & int_y & int_z, u[..., :, :, -2:-1], u)
    u = torch.where((gy == 0) & int_z, u[..., :, 1:2, :], u)
    u = torch.where((gy == NY - 1) & int_z, u[..., :, -2:-1, :], u)
    u = torch.where(gz == 0, u[..., 1:2, :, :], u)
    return torch.where(gz == NZ - 1, u[..., -2:-1, :, :], u)


def radiating_nlse_2d(u, m, dx, dy):
    """Radiating envelope BC on a complex (..., ny, nx) field; returns a new
    tensor.

    A local wavenumber k comes from the discrete Laplacian plus the
    nonlinear term m |u|^2 at the ring next to the edge, clamped to the
    Nyquist limit; each edge cell becomes e^{-i k h} times its inner
    neighbour. The neighbour sums of the ring cells read the field before
    any edge is written. Corners are then the mean of their two edge
    neighbours. `m` is the real (ny, nx) m field.
    """
    uc = u

    def k_eff(inner, nb_sum, m_row, h):
        lap = (nb_sum - 4.0 * inner) / (h * h)
        nonlinear = m_row * torch.abs(inner) ** 2
        k2 = torch.real(-lap / inner + nonlinear)
        bad = ~torch.isfinite(k2) | (k2 < 0)
        k2 = torch.where(bad, torch.abs(nonlinear), k2)
        k2 = torch.clamp(k2, max=2.0 / (h * h))
        return torch.sqrt(k2)

    def face(inner, nbs, m_row, h):
        return torch.exp(-1j * k_eff(inner, nbs, m_row, h) * h) * inner

    def nb4_row(i):
        return (uc[..., i + 1, 1:-1] + uc[..., i - 1, 1:-1]
                + torch.roll(uc, -1, dims=-1)[..., i, 1:-1]
                + torch.roll(uc, 1, dims=-1)[..., i, 1:-1])

    def nb4_col(j):
        return (uc[..., :, j + 1] + uc[..., :, j - 1]
                + torch.roll(uc, -1, dims=-2)[..., :, j]
                + torch.roll(uc, 1, dims=-2)[..., :, j])

    ny, nx = u.shape[-2], u.shape[-1]
    u = u.clone()
    u[..., 0, 1:-1] = face(uc[..., 1, 1:-1], nb4_row(1), m[..., 1, 1:-1], dx)
    u[..., -1, 1:-1] = face(uc[..., -2, 1:-1], nb4_row(ny - 2),
                            m[..., -2, 1:-1], dx)
    u[..., 1:-1, 0] = face(uc[..., 1:-1, 1], nb4_col(1)[..., 1:-1],
                           m[..., 1:-1, 1], dy)
    u[..., 1:-1, -1] = face(uc[..., 1:-1, -2], nb4_col(nx - 2)[..., 1:-1],
                            m[..., 1:-1, -2], dy)
    # corners: the mean of the two adjacent edge cells
    u[..., 0, 0] = 0.5 * (u[..., 0, 1] + u[..., 1, 0])
    u[..., 0, -1] = 0.5 * (u[..., 0, -2] + u[..., 1, -1])
    u[..., -1, 0] = 0.5 * (u[..., -2, 0] + u[..., -1, 1])
    u[..., -1, -1] = 0.5 * (u[..., -2, -1] + u[..., -1, -2])
    return u
