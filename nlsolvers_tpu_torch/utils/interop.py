"""Carry state, fields and problem parameters across from the JAX package.

Everything crosses as numpy, copied (JAX hands out read-only arrays). Used
to hand a JAX problem's state after k steps to the port and compare the next
step: the state of a one-step integrator (SS2, planar or, on the resident
path, complex), or the (u, u_prev) pair of a two-step one (sEWI, Gautschi).
`switches_from_jax` reads the JAX run's opt-in kernel switches, and
`set_switches` sets the port's to them. For a grid-sharded run,
`mesh_like` builds a port mesh of a JAX mesh's shape and axis names;
parallel/shards.shard takes a global numpy array (the packed state u_packed,
m_field, c) to the port's sharded field, and shards.gather takes it back.
The real-wave counterparts: `realwave_state_from_numpy` carries the real
state (u, u_past), and `realwave_args_from_meta` builds realwave_problem's
arguments from JAX's meta with m_field and c_field beside it.
"""

import numpy as np
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.models.realwave import gautschi_filter
from nlsolvers_tpu_torch.parallel.mesh import Mesh

__all__ = ["state_from_numpy", "field_from_numpy", "nlse_args_from_meta",
           "realwave_state_from_numpy", "realwave_args_from_meta",
           "switches_from_jax", "set_switches", "mesh_like"]

# the port's opt-in switches (config attributes)
SWITCHES = ("resident_mode", "fused_iter", "pipeline_3d")


def switches_from_jax(jax_config, jax_lanczos2d):
    """The port's switches as a JAX run has them, from the JAX package's
    config module (resident_mode, pallas_pipeline_3d) and its
    ops/pallas/lanczos2d module (the private _FUSED_ITER); the objects are
    passed in, this module imports neither."""
    return {"resident_mode": jax_config.resident_mode,
            "fused_iter": bool(jax_lanczos2d._FUSED_ITER),
            "pipeline_3d": bool(jax_config.pallas_pipeline_3d)}


def set_switches(**values):
    """Set the port's opt-in switches (config.resident_mode, fused_iter,
    pipeline_3d); returns their previous values, for restoring."""
    unknown = set(values) - set(SWITCHES)
    if unknown:
        raise ValueError(f"unknown switches {sorted(unknown)}")
    old = {k: getattr(config, k) for k in values}
    for k, v in values.items():
        setattr(config, k, v)
    return old


def state_from_numpy(x, shape, device):
    """A JAX problem's state (as numpy) in the port's layout on `device`.

    x: planar (2, R, nx) float32, packed (2,) + shape, or complex `shape`,
    for a grid `shape` = (ny, nx) or (nz, ny, nx). Real stacks become the
    planar (2, R, nx) float32 state of the port's planar problems, with
    R = ny in 2D and nz*ny in 3D; complex arrays stay complex, of their own
    dtype. A two-step state, a tuple or list (u, u_prev) of such arrays,
    becomes the tuple of the two: the port's two-step state, which goes to
    `step` as it is (`init` takes a single field).
    """
    if isinstance(x, (tuple, list)):
        if len(x) != 2:
            raise ValueError(f"a two-step state is a pair (u, u_prev), got "
                             f"{len(x)} arrays")
        return tuple(state_from_numpy(a, shape, device) for a in x)
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
    parameters, and the integrator (SS2 or a two-step one). JAX's meta does
    not hold the c(x) field: pass the JAX problem's `c_field` (numpy, the
    grid's shape, 2D or 3D) to carry it across. m_field, dtype and device
    are the caller's to add."""
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


def realwave_state_from_numpy(x, shape, device):
    """A JAX real-wave state (u, u_past), as numpy, as the port's tuple of
    two real tensors of the grid `shape` on `device`, dtype unchanged."""
    if not isinstance(x, (tuple, list)) or len(x) != 2:
        raise ValueError("a real-wave state is a pair (u, u_past)")
    out = []
    for a in x:
        a = np.asarray(a)
        if np.iscomplexobj(a) or a.shape != tuple(shape):
            raise ValueError(f"real-wave state {a.shape} {a.dtype} is not a "
                             f"real {tuple(shape)} field")
        out.append(torch.from_numpy(np.array(a)).to(device))
    return tuple(out)


def _field_arg(a, shape, name):
    a = np.asarray(a)
    if a.shape != shape:
        raise ValueError(f"{name} {a.shape} != grid {shape}")
    return a


def realwave_args_from_meta(meta, m_field=None, c_field=None):
    """(args, kwargs) for the port's realwave_problem from a JAX real-wave
    Problem.meta: the kind, grid (2D or 3D), Lx, dt, Krylov m and
    integrator, with the Gautschi filter checked against the kind. JAX's
    meta holds neither field: pass the JAX problem's `m_field` and, for
    div(c grad u), its `c_field` (numpy, the grid's shape) to carry them
    across. variant, dtype and device are the caller's to add."""
    kind = meta["equation"]
    shape = tuple(meta["shape"])
    if meta["dim"] != len(shape) or meta["dim"] not in (2, 3):
        raise ValueError(f"meta of dim {meta['dim']} with shape {shape}")
    want = gautschi_filter(kind)
    if meta["filter"] != want:
        raise ValueError(f"{kind}: filter {meta['filter']!r}, the port "
                         f"uses {want!r}")
    args = (kind, shape, meta["Lx"], meta["dt"])
    kwargs = dict(krylov_m=meta["krylov_m"], integrator=meta["integrator"])
    if m_field is not None:
        kwargs["m_field"] = _field_arg(m_field, shape, "m_field")
    if c_field is not None:
        kwargs["c_field"] = _field_arg(c_field, shape, "c_field")
    return args, kwargs


def mesh_like(jax_mesh, device):
    """A port mesh with the shape and axis names of a JAX mesh (any object
    with .axis_names and a .shape mapping from name to size, as
    jax.sharding.Mesh has), every shard on `device`."""
    names = tuple(jax_mesh.axis_names)
    shape = tuple(int(jax_mesh.shape[a]) for a in names)
    return Mesh(shape, names, (torch.device(device),) * int(np.prod(shape)))
