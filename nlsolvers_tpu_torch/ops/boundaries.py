"""No-flux ghost copies in 2D and 3D (port of nlsolvers_tpu/ops/boundaries.py).

The update order of the reference is kept, since it decides the edges and
corners:
2D (boundaries.hpp:41-57): first the two x-edge rows over interior columns,
then the two full y-edge columns, which also set the corners.
3D (boundaries_3d.hpp:8-31): x faces over interior (y, z), then y faces over
interior z and all x, then z faces over all (x, y).
The radiating boundary is not ported yet (ROADMAP.md queue 1, item 2).
"""

__all__ = ["neumann_no_velocity_2d", "neumann_no_velocity_3d"]


def neumann_no_velocity_2d(u):
    """u-only ghost copy on (..., ny, nx); returns a new tensor."""
    u = u.clone()
    u[..., 0, 1:-1] = u[..., 1, 1:-1]
    u[..., -1, 1:-1] = u[..., -2, 1:-1]
    u[..., :, 0] = u[..., :, 1]
    u[..., :, -1] = u[..., :, -2]
    return u


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
