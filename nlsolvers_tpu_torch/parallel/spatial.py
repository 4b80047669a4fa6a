"""Spatial domain decomposition: grids sharded over a device mesh (port of
nlsolvers_tpu/parallel/spatial.py, the single-trajectory SS2 step).

The JAX package runs its local closures inside shard_map; the port runs the
same arithmetic over a sharded field, a list of local tensors, one per shard
of a single-process mesh (parallel/mesh.py, parallel/shards.py). A closure
here takes and returns such lists. Halos are one deep: an edge shard of a
mesh axis receives zeros, which is the no-flux stencil's missing neighbour,
so the halo IS the boundary condition. The reference-variant diagonal and
the Neumann ghost copies need global coordinates, which come from the
shard's place in the mesh.

`make_sharded_nlse_step` is the complex64 planar SS2 step: the half kicks
per shard (ops/cuda/kick.py, density included), the matrix function through
the sharded Lanczos loops (parallel/lanczos.py: the shard kernels, K4 pass2
and K3 combine per shard, one packed psum per iteration); the closing kick
also does each shard's ghost copy, with the shard's global offsets.
"""

import numpy as np
import torch

from nlsolvers_tpu_torch.models import nlse as nlse_mod
from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
from nlsolvers_tpu_torch.ops.boundaries import (
    neumann_no_velocity_2d_block, neumann_no_velocity_3d_block)
from nlsolvers_tpu_torch.ops.cuda.kick import kick_grid
from nlsolvers_tpu_torch.ops.operators import (block_coords,
                                               boundary_diagonal,
                                               neighbor_sum)
from nlsolvers_tpu_torch.parallel.lanczos import supported_shard
from nlsolvers_tpu_torch.parallel.shards import (local_shape, offsets,
                                                 recv_from_next,
                                                 recv_from_prev)

__all__ = [
    "halo_neighbor_sum",
    "sharded_laplacian_2d",
    "sharded_anisotropic_laplacian_2d",
    "sharded_anisotropic_laplacian_3d",
    "sharded_neumann_2d",
    "sharded_laplacian_3d",
    "sharded_neumann_3d",
    "make_sharded_nlse_step",
]

# The arguments that wait for later slices (ROADMAP.md, queue 1 item 2).
_LATER = "ROADMAP.md queue 1 item 2"


def halo_neighbor_sum(parts, dim, mesh, axis_name):
    """u[i-1] + u[i+1] along one grid dimension sharded over `axis_name`,
    with cross-shard halos and zeros at the global ends (the sharded
    ops.operators.neighbor_sum)."""
    n = parts[0].shape[dim]
    nxt = recv_from_next([u.narrow(dim, 0, 1) for u in parts], mesh,
                         axis_name)
    prv = recv_from_prev([u.narrow(dim, n - 1, 1) for u in parts], mesh,
                         axis_name)
    return [torch.cat([u.narrow(dim, 1, n - 1), hn], dim=dim)
            + torch.cat([hp, u.narrow(dim, 0, n - 1)], dim=dim)
            for u, hn, hp in zip(parts, nxt, prv)]


def _global_coords(local_shape_, mesh, k, axis_names, device):
    """Global index tensors of shard k's block, one per grid dimension,
    each broadcastable to the block's shape (the lax.axis_index iotas of
    the JAX package's _global_coords and _global_coords_3d)."""
    return block_coords(offsets(mesh, k, axis_names, local_shape_),
                        local_shape_, device)


def _coords_of(parts, mesh, axis_names):
    nd = len(axis_names)
    return [_global_coords(tuple(u.shape[-nd:]), mesh, k, axis_names,
                           u.device) for k, u in enumerate(parts)]


def sharded_laplacian_2d(global_shape, dx, dy, mesh, axis_names=("gy", "gx"),
                         variant="reference", dtype=torch.float32):
    """The 2D no-flux Laplacian on a (ay, ax)-sharded grid, with the
    semantics of ops.operators.laplacian_2d on the gathered global field
    (the -3 ring diagonal of the reference included). Returns apply(parts)."""
    NY, NX = global_shape
    ay, ax = axis_names
    scale = 1.0 / (dx * dy)
    if variant not in ("reference", "clean"):
        raise ValueError(f"unknown variant {variant!r}")

    def apply(parts):
        nbx = halo_neighbor_sum(parts, -1, mesh, ax)
        nby = halo_neighbor_sum(parts, -2, mesh, ay)
        out = []
        for u, (gy, gx), a, b in zip(parts, _coords_of(parts, mesh,
                                                       axis_names), nbx, nby):
            diag = boundary_diagonal((gy, gx), (NY, NX), variant, dtype)
            out.append((a + b + diag * u) * scale)
        return out

    # descriptor for the sharded Lanczos loop (parallel/lanczos.py)
    apply.kernel_desc = dict(kind="shard2d", NY=int(NY), NX=int(NX),
                             scale=float(scale), sign=1.0, variant=variant,
                             ay=ay, ax=ax, mesh=mesh)
    return apply


def sharded_neumann_2d(global_shape, mesh, axis_names=("gy", "gx")):
    """The Neumann ghost copy on a sharded 2D grid, in the update order of
    boundaries.hpp:41-57 (edge rows over interior global columns, then the
    full edge columns), by where-masks on global coordinates. Local blocks
    need at least 2 rows and columns."""

    def apply(parts):
        return [neumann_no_velocity_2d_block(u, c, global_shape)
                for u, c in zip(parts, _coords_of(parts, mesh, axis_names))]

    return apply


def _check_reference(local, global_shape, aniso):
    """The 3D reference variant's y-seam links the last y-row of each
    z-plane to the next plane's first row: shard-local only when z and y are
    not split. Raises the JAX package's ValueError otherwise."""
    if local[0] == global_shape[0] and local[1] == global_shape[1]:
        return
    if aniso:
        raise ValueError(
            "variant='reference' 3D anisotropic sharding requires unsplit z "
            "and y axes (the merged-row seam is not shard-local); use "
            "variant='clean' or shard only gx")
    raise ValueError(
        "variant='reference' 3D sharding requires unsplit z and y axes (the "
        "y-seam quirk is not shard-local); use variant='clean' or shard only "
        "gx")


def sharded_laplacian_3d(global_shape, dx, mesh,
                         axis_names=("gz", "gy", "gx"), variant="clean",
                         dtype=torch.float32):
    """The 3D no-flux Laplacian on an (az, ay, ax)-sharded grid, scaled
    1/dx^2 (laplacians.hpp:105-156). variant="clean" works under any
    sharding; variant="reference" keeps the cross-plane y-seam and needs
    the z and y axes unsplit (a ValueError otherwise, as in the JAX
    package). Returns apply(parts)."""
    NZ, NY, NX = global_shape
    az, ay, ax = axis_names
    scale = 1.0 / (dx * dx)
    if variant not in ("reference", "clean"):
        raise ValueError(f"unknown variant {variant!r}")

    def apply(parts):
        lnz, lny, lnx = parts[0].shape[-3:]
        if variant == "reference":
            _check_reference((lnz, lny), global_shape, aniso=False)
        nbx = halo_neighbor_sum(parts, -1, mesh, ax)
        nbz = halo_neighbor_sum(parts, -3, mesh, az)
        nby = (halo_neighbor_sum(parts, -2, mesh, ay)
               if variant == "clean" else None)
        out = []
        for k, (u, (gz, gy, gx)) in enumerate(zip(
                parts, _coords_of(parts, mesh, axis_names))):
            nb = nbx[k] + nbz[k]
            if variant == "reference":
                v = u.reshape(u.shape[:-3] + (lnz * lny, lnx))
                nb = nb + neighbor_sum(v, -2).reshape(u.shape)
            else:
                nb = nb + nby[k]
            diag = boundary_diagonal((gz, gy, gx), global_shape, variant,
                                     dtype)
            out.append((nb + diag * u) * scale)
        return out

    apply.kernel_desc = dict(kind="shard3d", NZ=int(NZ), NY=int(NY),
                             NX=int(NX), scale=float(scale), sign=1.0,
                             variant=variant, az=az, ay=ay, ax=ax, mesh=mesh)
    return apply


def _aniso_flux_axis(u, c, dim, mesh, axis_name, gcs, N):
    """Conservative flux divergence along ONE sharded dimension:
    f_i - f_{i-1} with f_i = 0.5 (c_i + c_{i+1}) (u_{i+1} - u_i), the
    cross-shard faces from the neighbours' edge slabs of BOTH u and c, and
    no-flux (zero) faces at the global ends (`gcs`: each shard's global
    coordinate along `dim`). Lists in, a list out."""
    n = u[0].shape[dim]
    first = lambda parts: [p.narrow(dim, 0, 1) for p in parts]
    last = lambda parts: [p.narrow(dim, n - 1, 1) for p in parts]
    u_nx = recv_from_next(first(u), mesh, axis_name)
    c_nx = recv_from_next(first(c), mesh, axis_name)
    u_pv = recv_from_prev(last(u), mesh, axis_name)
    c_pv = recv_from_prev(last(c), mesh, axis_name)
    out = []
    for k, (uk, ck, gc) in enumerate(zip(u, c, gcs)):
        u_next = torch.cat([uk.narrow(dim, 1, n - 1), u_nx[k]], dim=dim)
        c_next = torch.cat([ck.narrow(dim, 1, n - 1), c_nx[k]], dim=dim)
        f = 0.5 * (ck + c_next) * (u_next - uk)
        f = torch.where(gc == N - 1, 0.0, f)          # no face past the end
        u0, c0 = uk.narrow(dim, 0, 1), ck.narrow(dim, 0, 1)
        f_edge = 0.5 * (c_pv[k] + c0) * (u0 - u_pv[k])
        f_back = torch.cat([f_edge, f.narrow(dim, 0, n - 1)], dim=dim)
        f_back = torch.where(gc == 0, 0.0, f_back)    # no face before it
        out.append(f - f_back)
    return out


def sharded_anisotropic_laplacian_2d(global_shape, dx, dy, mesh,
                                     axis_names=("gy", "gx")):
    """Finite-volume div(c grad u) on a sharded 2D grid, with the semantics
    of ops.operators.anisotropic_laplacian_2d on the gathered global field
    (laplacians.hpp:54-103). Returns apply(parts, c_parts): c is a sharded
    field given at each call."""
    NY, NX = global_shape
    ay, ax = axis_names
    scale = 1.0 / (dx * dy)

    def apply(parts, c):
        coords = _coords_of(parts, mesh, axis_names)
        fx = _aniso_flux_axis(parts, c, -1, mesh, ax,
                              [g[1] for g in coords], NX)
        fy = _aniso_flux_axis(parts, c, -2, mesh, ay,
                              [g[0] for g in coords], NY)
        return [(a + b) * scale for a, b in zip(fx, fy)]

    return apply


def sharded_anisotropic_laplacian_3d(global_shape, dx, mesh,
                                     axis_names=("gz", "gy", "gx"),
                                     variant="clean"):
    """Finite-volume div(c grad u) on a sharded 3D grid, scaled 1/dx^2
    (laplacians.hpp:158-218). variant="clean" (plane-local y faces) works
    under any sharding; "reference" keeps the merged (z*y)-row faces whose
    seam couples the last y-row of a plane to the next plane's first row,
    and needs the z and y axes unsplit. Returns apply(parts, c_parts)."""
    NZ, NY, NX = global_shape
    az, ay, ax = axis_names
    scale = 1.0 / (dx * dx)
    if variant not in ("reference", "clean"):
        raise ValueError(f"unknown variant {variant!r}")

    def apply(parts, c):
        lnz, lny, lnx = parts[0].shape[-3:]
        if variant == "reference":
            _check_reference((lnz, lny), global_shape, aniso=True)
        coords = _coords_of(parts, mesh, axis_names)
        fx = _aniso_flux_axis(parts, c, -1, mesh, ax,
                              [g[2] for g in coords], NX)
        fz = _aniso_flux_axis(parts, c, -3, mesh, az,
                              [g[0] for g in coords], NZ)
        if variant == "clean":
            fy = _aniso_flux_axis(parts, c, -2, mesh, ay,
                                  [g[1] for g in coords], NY)
        else:
            R = lnz * lny
            fy = []
            for u, ck in zip(parts, c):
                um = u.reshape(u.shape[:-3] + (R, lnx))
                cm = ck.reshape(ck.shape[:-3] + (R, lnx))
                wy = 0.5 * (cm[..., :-1, :] + cm[..., 1:, :])
                f = wy * (um[..., 1:, :] - um[..., :-1, :])
                zrow = torch.zeros(f.shape[:-2] + (1, lnx), dtype=f.dtype,
                                   device=f.device)
                fy.append((torch.cat([f, zrow], dim=-2)
                           - torch.cat([zrow, f], dim=-2)).reshape(u.shape))
        return [(a + b + cc) * scale for a, b, cc in zip(fx, fz, fy)]

    return apply


def sharded_neumann_3d(global_shape, mesh, axis_names=("gz", "gy", "gx")):
    """The Neumann ghost copy on a sharded 3D grid (boundaries_3d.hpp:8-31)
    by where-masks on global coordinates, in the order of
    ops.boundaries.neumann_no_velocity_3d: x faces (interior y, z), y faces
    (interior z), z faces. Local blocks need at least 2 cells per axis.
    The sharded step folds the copy into its closing half kick
    (ops/cuda/kick.py), whose plain version runs this arithmetic."""

    def apply(parts):
        return [neumann_no_velocity_3d_block(u, c, global_shape)
                for u, c in zip(parts, _coords_of(parts, mesh, axis_names))]

    return apply


def _sharded_lap(global_shape, dx, mesh, axis_names, variant, rdtype):
    if len(global_shape) == 2:
        return sharded_laplacian_2d(global_shape, dx, dx, mesh, axis_names,
                                    variant=variant, dtype=rdtype)
    return sharded_laplacian_3d(global_shape, dx, mesh, axis_names,
                                variant=variant, dtype=rdtype)


def _sharded_neumann(global_shape, mesh, axis_names):
    if len(global_shape) == 2:
        return sharded_neumann_2d(global_shape, mesh, axis_names)
    return sharded_neumann_3d(global_shape, mesh, axis_names)


def _sharded_aniso(global_shape, dx, mesh, axis_names, variant):
    if len(global_shape) == 2:
        return sharded_anisotropic_laplacian_2d(global_shape, dx, dx, mesh,
                                                axis_names)
    return sharded_anisotropic_laplacian_3d(global_shape, dx, mesh,
                                            axis_names, variant=variant)


def _aniso_desc(global_shape, dx, mesh, axis_names, variant, cloc, sign):
    """The kernel descriptor of the sharded div(c grad u) for one call: the
    local c fields `cloc` (a sharded field) are part of it."""
    if len(global_shape) == 2:
        return dict(kind="shard2d_aniso", NY=global_shape[0],
                    NX=global_shape[1], scale=1.0 / (dx * dx), sign=sign,
                    variant="aniso", ay=axis_names[0], ax=axis_names[1],
                    c=cloc, mesh=mesh)
    return dict(kind="shard3d_aniso", NZ=global_shape[0], NY=global_shape[1],
                NX=global_shape[2], scale=1.0 / (dx * dx), sign=sign,
                variant=variant, az=axis_names[0], ay=axis_names[1],
                ax=axis_names[2], c=cloc, mesh=mesh)


def make_sharded_nlse_step(kind, global_shape, Lx, dt, mesh,
                           axis_names=("gy", "gx"), batch_axis=None,
                           sigma1=1.0, sigma2=-0.1, kappa=1.0,
                           krylov_m=10, dtype=torch.complex64,
                           variant="reference", apply_bc=True, reorth=True,
                           use_c=False):
    """An SS2 step over a spatially sharded grid.

    Returns step(u_parts, m_parts) -> u_parts, or step(u_parts, m_parts,
    c_parts) with use_c=True (the finite-volume div(c grad u) with
    cross-shard face fluxes). Every argument is a sharded field
    (parallel/shards.shard): u is planar, (2,) + the local block of each
    shard, stacked (re, im) float32; m and c are float32 local blocks. 3D
    grids take axis_names=("gz", "gy", "gx"). The state stays sharded from
    step to step; shards.gather makes it one global field. With apply_bc
    every step ends with the Neumann ghost copy (done by the closing half
    kick); apply_bc=False skips it.

    The port takes the complex64 planar path of the JAX package
    (local_single_planar). batch_axis, dtype=complex128 and reorth=False
    wait for later slices and raise NotImplementedError.
    """
    if batch_axis is not None:
        raise NotImplementedError(f"batch_axis: the trajectory-batched "
                                  f"sharded step is not ported yet ({_LATER})")
    if dtype != torch.complex64 or not reorth:
        raise NotImplementedError(f"the sharded step takes complex64 with "
                                  f"reorth=True (the planar path); the "
                                  f"complex path is not ported yet ({_LATER})")
    global_shape = tuple(int(g) for g in global_shape)
    axis_names = tuple(axis_names)
    nx = global_shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    lshape = local_shape(global_shape, mesh, axis_names)
    if min(lshape) < 2:
        raise ValueError(f"local blocks {lshape} need at least 2 cells per "
                         f"axis (the ghost copy)")
    three_d = len(global_shape) == 3
    if use_c:
        probe = _aniso_desc(global_shape, dx, mesh, axis_names, variant, [],
                            1.0)
    else:
        lap = _sharded_lap(global_shape, dx, mesh, axis_names, variant,
                           torch.float32)
        probe = lap.kernel_desc
    if three_d:
        if variant == "reference":
            _check_reference(lshape, global_shape, aniso=use_c)
        probe = dict(probe, lnz=lshape[0], lny=lshape[1])
    if not supported_shard(probe, lshape, dtype):
        raise ValueError(f"the sharded kernels do not take {probe['kind']} "
                         f"(variant {variant!r}) on local blocks {lshape}")
    Rl, nxl = int(np.prod(lshape[:-1])), lshape[-1]
    # each shard's closing half kick does its block's ghost copy
    grids = ([kick_grid(lshape, global_shape,
                        offsets(mesh, k, axis_names, lshape))
              for k in range(mesh.size)] if apply_bc else None)

    def step(u_parts, m_parts, c_parts=None):
        if use_c:
            if c_parts is None:
                raise ValueError("use_c=True: step(u, m, c) takes the c field")
            cloc = [c.to(torch.float32).contiguous() for c in c_parts]
            desc = _aniso_desc(global_shape, dx, mesh, axis_names, variant,
                               cloc, 1.0)
        else:
            desc = lap.kernel_desc
        if three_d:
            desc = dict(desc, lnz=lshape[0], lny=lshape[1])
        rhos = [nlse_density_planar(kind, m.to(torch.float32).reshape(Rl, nxl),
                                    sigma1=sigma1, sigma2=sigma2,
                                    kappa=kappa) for m in m_parts]
        ups = [u.to(torch.float32).reshape(2, Rl, nxl) for u in u_parts]
        out = nlse_mod.ss2_step_planar_sharded(ups, desc, rhos, dt,
                                               m=krylov_m, grids=grids)
        return [o.reshape((2,) + lshape) for o in out]

    return step
