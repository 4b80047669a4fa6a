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

    x: planar (2, R, nx) float32, packed (2, ny, nx), or complex `shape`.
    Real stacks become the planar (2, ny, nx) float32 state of the port's
    planar problems; complex arrays stay complex, of their own dtype.
    """
    x = np.asarray(x)
    if np.iscomplexobj(x):
        if x.shape != tuple(shape):
            raise ValueError(f"complex state {x.shape} != {tuple(shape)}")
        return torch.from_numpy(np.array(x)).to(device)
    if x.shape[0] != 2 or x.size != 2 * int(np.prod(shape)):
        raise ValueError(f"planar state {x.shape} does not hold a "
                         f"(2,) + {tuple(shape)} field")
    planar = np.array(x, np.float32).reshape((2,) + tuple(shape))
    return torch.from_numpy(planar).to(device)


def field_from_numpy(a, device):
    """A numpy field (m_field, an initial condition) as a tensor on `device`,
    dtype and values unchanged."""
    return torch.from_numpy(np.array(a)).to(device)


def nlse_args_from_meta(meta):
    """(args, kwargs) for the port's nlse_problem from a JAX Problem.meta:
    the same kind, grid, Lx, dt, Krylov m, variant, BC and parameters.
    m_field, dtype and device are the caller's to add."""
    kind = meta["equation"].removeprefix("nlse_")
    args = (kind, tuple(meta["shape"]), meta["Lx"], meta["dt"])
    kwargs = dict(krylov_m=meta["krylov_m"], variant=meta["variant"],
                  bc=meta["bc"], integrator=meta["integrator"],
                  **meta["params"])
    return args, kwargs
