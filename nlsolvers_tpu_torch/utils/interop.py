"""Carry state, fields and problem parameters across from the JAX package.

Everything crosses as numpy, copied (JAX hands out read-only arrays). Used
to hand a JAX problem's state after k steps to the port and compare the next
step.
"""

import numpy as np
import torch

__all__ = ["state_from_numpy", "field_from_numpy", "nlse_args_from_meta"]


def state_from_numpy(x, shape, device):
    """A JAX problem's state (as numpy) in the port's layout on `device`.

    x: planar (2, R, nx) float32, packed (2,) + shape, or complex `shape`,
    for a grid `shape` = (ny, nx) or (nz, ny, nx). Real stacks become the
    planar (2, R, nx) float32 state of the port's planar problems, with
    R = ny in 2D and nz*ny in 3D; complex arrays stay complex, of their own
    dtype.
    """
    x = np.asarray(x)
    shape = tuple(shape)
    if np.iscomplexobj(x):
        if x.shape != shape:
            raise ValueError(f"complex state {x.shape} != {shape}")
        return torch.from_numpy(np.array(x)).to(device)
    if x.shape[0] != 2 or x.size != 2 * int(np.prod(shape)):
        raise ValueError(f"planar state {x.shape} does not hold a "
                         f"(2,) + {shape} field")
    planar = np.array(x, np.float32).reshape(2, -1, shape[-1])
    return torch.from_numpy(planar).to(device)


def field_from_numpy(a, device):
    """A numpy field (m_field, c_field, an initial condition) as a tensor on
    `device`, dtype and values unchanged."""
    return torch.from_numpy(np.array(a)).to(device)


def nlse_args_from_meta(meta, c_field=None):
    """(args, kwargs) for the port's nlse_problem from a JAX Problem.meta:
    the same kind, grid (2D or 3D), Lx, dt, Krylov m, variant, BC and
    parameters. JAX's meta does not hold the c(x) field: pass the JAX
    problem's `c_field` (numpy, the grid's shape) to carry it across. m_field,
    dtype and device are the caller's to add."""
    kind = meta["equation"].removeprefix("nlse_")
    shape = tuple(meta["shape"])
    if meta["dim"] != len(shape) or meta["dim"] not in (2, 3):
        raise ValueError(f"meta of dim {meta['dim']} with shape {shape}")
    args = (kind, shape, meta["Lx"], meta["dt"])
    kwargs = dict(krylov_m=meta["krylov_m"], variant=meta["variant"],
                  bc=meta["bc"], integrator=meta["integrator"],
                  **meta["params"])
    if c_field is not None:
        c = np.asarray(c_field)
        if c.shape != shape:
            raise ValueError(f"c_field {c.shape} != grid {shape}")
        kwargs["c_field"] = c
    return args, kwargs
