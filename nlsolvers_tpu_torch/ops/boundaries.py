"""No-flux ghost copy in 2D (port of nlsolvers_tpu/ops/boundaries.py).

The corner update order of the reference (boundaries.hpp:41-57) is kept:
first the two x-edge rows over interior columns, then the two full y-edge
columns, which also set the corners. The 3D copy and the radiating boundary
are not ported yet (ROADMAP.md queue 1, items 2 and 8).
"""

__all__ = ["neumann_no_velocity_2d"]


def neumann_no_velocity_2d(u):
    """u-only ghost copy on (..., ny, nx); returns a new tensor."""
    u = u.clone()
    u[..., 0, 1:-1] = u[..., 1, 1:-1]
    u[..., -1, 1:-1] = u[..., -2, 1:-1]
    u[..., :, 0] = u[..., :, 1]
    u[..., :, -1] = u[..., :, -2]
    return u
