"""Spatial domain decomposition: grids sharded over a device mesh (port of
nlsolvers_tpu/parallel/spatial.py: the sharded steps and the grid-sharded
trajectory engines).

The JAX package runs its local closures inside shard_map; the port runs the
same arithmetic over a sharded field, a list of local tensors, one per shard
of a single-process mesh (parallel/mesh.py, parallel/shards.py). A closure
here takes and returns such lists. Halos are one deep: an edge shard of a
mesh axis receives zeros, which is the no-flux stencil's missing neighbour,
so the halo IS the boundary condition. The reference-variant diagonal and
the Neumann ghost copies need global coordinates, which come from the
shard's place in the mesh.

`make_sharded_nlse_step` is the SS2 step. complex64 takes the planar path:
the half kicks per shard (ops/cuda/kick.py, density included), the matrix
function through the sharded Lanczos loops (parallel/lanczos.py: the shard
kernels, K4 pass2 and K3 combine per shard, one packed psum per
iteration); the closing kick also does each shard's ghost copy, with the
shard's global offsets. complex128 and reorth=False take the generic path
(JAX's local_single): complex blocks, models/nlse.py with the mesh, whose
Lanczos sums each dot over the shards (ops/krylov.py), on the plain
sharded operators. `make_sharded_realwave_step` is the real-wave step:
float32 Gautschi through the shard kernels at P=1 on -Lap, float64 or
reorth=False Gautschi on the generic path, or Stormer-Verlet on the plain
sharded operator in any real dtype.

A mesh axis that splits no grid dimension, `batch_axis`, splits the lanes
of a batch (JAX's P(batch_axis, ...)): the mesh is one grid sub-mesh per
batch index (parallel/mesh.batch_blocks), each of which runs its block of
lanes through everything above; nothing crosses the batch axis.

The trajectory engines (`make_sharded_nlse_trajectory_fn`,
`make_sharded_realwave_trajectory_fn`) are the datagen path for one
trajectory too large for one card, with the contract of
pipeline/engine.py: global (B, ...) inputs are sharded (shards.shard),
every lane of the batch steps in ONE batched sharded step, as JAX's vmap of
the step inside shard_map (each kernel one launch per shard over the lanes,
lane b with the bits of the step run on lane b alone), and every snapshot
is gathered into one global tensor on the first shard's device (on the
generic path the lanes step in turn). The guard checks that gathered
snapshot, so each lane's verdict covers every shard (JAX's psum of the
shards' bits) and all shards stop together; the mass and energy series are
each shard's sums of each lane alone, psum'd in shard order, so a lane's
series does not depend on its batch. With a batch axis each sub-mesh
runs its own loop on its lanes, as each batch shard does under shard_map.
"""

from functools import partial

import numpy as np
import torch

from nlsolvers_tpu_torch.config import real_dtype_of, torch_dtype
from nlsolvers_tpu_torch.models import nlse as nlse_mod
from nlsolvers_tpu_torch.models import realwave as rw
from nlsolvers_tpu_torch.models.evolve import (evolve_lanes, lane_sums,
                                               lanes_in_turn, tree_map)
from nlsolvers_tpu_torch.models.nonlinearities import (NLSE_KINDS,
                                                       REALWAVE_KINDS,
                                                       nlse_density,
                                                       nlse_density_planar,
                                                       realwave_g,
                                                       realwave_potential)
from nlsolvers_tpu_torch.ops.boundaries import (
    neumann_no_velocity_2d_block, neumann_no_velocity_3d_block)
from nlsolvers_tpu_torch.ops.cuda.bc3d import neumann_bc_planar_3d
from nlsolvers_tpu_torch.ops.cuda.kick import kick_grid
from nlsolvers_tpu_torch.ops.operators import (block_coords,
                                               boundary_diagonal,
                                               neighbor_sum)
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel.lanczos import supported_shard
from nlsolvers_tpu_torch.parallel.mesh import batch_blocks, lane_blocks
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
    "sharded_gradient",
    "make_sharded_nlse_step",
    "make_sharded_realwave_step",
    "make_sharded_nlse_trajectory_fn",
    "make_sharded_realwave_trajectory_fn",
]

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


def _per_block(mesh, batch_axis, build):
    """[(shard indices, build(sub-mesh))] for each batch index of the mesh
    (parallel/mesh.batch_blocks): one entry, the mesh itself, without a
    batch axis. Raises JAX's ValueError when batch_axis is no axis of the
    mesh."""
    return [(ks, build(sub)) for sub, ks in batch_blocks(mesh, batch_axis)]


def _block_of(global_shape, mesh, axis_names):
    """The local block of every shard, checked: sides of at least 2 (the
    ghost copy)."""
    lshape = local_shape(global_shape, mesh, axis_names)
    if min(lshape) < 2:
        raise ValueError(f"local blocks {lshape} need at least 2 cells per "
                         f"axis (the ghost copy)")
    return lshape


def _shard_desc(global_shape, dx, mesh, axis_names, variant, use_c, lshape):
    """desc_of(c_parts): the shard descriptor of the sharded Laplacian, or
    of the sharded div(c grad u) for the c fields of one call (each shard's
    float32 ([B,] *block) c), checked once against the shard kernels."""
    three_d = len(global_shape) == 3
    if use_c:
        probe = _aniso_desc(global_shape, dx, mesh, axis_names, variant, [],
                            1.0)
    else:
        probe = _sharded_lap(global_shape, dx, mesh, axis_names, variant,
                             torch.float32).kernel_desc
    if three_d:
        if variant == "reference":
            _check_reference(lshape, global_shape, aniso=use_c)
        probe = dict(probe, lnz=lshape[0], lny=lshape[1])
    if not supported_shard(probe, lshape, torch.float32):
        raise ValueError(f"the sharded kernels do not take {probe['kind']} "
                         f"(variant {variant!r}) on local blocks {lshape}")

    def desc_of(c_parts):
        if not use_c:
            return probe
        if c_parts is None:
            raise ValueError("use_c=True: the step takes the c field")
        cloc = [c.to(torch.float32).contiguous() for c in c_parts]
        desc = _aniso_desc(global_shape, dx, mesh, axis_names, variant, cloc,
                           1.0)
        return dict(desc, lnz=lshape[0], lny=lshape[1]) if three_d else desc

    return desc_of


def _planar_nlse(kind, global_shape, Lx, dt, mesh, axis_names, integrator,
                 sigma1, sigma2, kappa, krylov_m, variant, apply_bc, use_c):
    """step_of(m_parts, c_parts) -> step(state, i) of a planar NLSE
    integrator on a sharded grid: state is a sharded field of ([B,] 2, Rl,
    nxl) float32 blocks (a pair of them for the two-step integrators, whose
    index 1 is the SS2 bootstrap), m and c each shard's ([B,] *block)
    fields. The SS2 step's closing kick does the ghost copy (each shard at
    its offsets); a two-step step is followed by the plain sharded copy in
    2D and bc3d at the shard's offsets in 3D (JAX's `fix`)."""
    if integrator not in ("ss2", "sewi", "sewi_fused", "gautschi"):
        raise ValueError(f"unknown NLSE integrator {integrator!r}")
    if kind not in NLSE_KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    global_shape = tuple(int(g) for g in global_shape)
    axis_names = tuple(axis_names)
    dx = 2.0 * Lx / (global_shape[-1] - 1)
    lshape = _block_of(global_shape, mesh, axis_names)
    desc_of = _shard_desc(global_shape, dx, mesh, axis_names, variant, use_c,
                          lshape)
    Rl, nxl = int(np.prod(lshape[:-1])), lshape[-1]
    offs = [offsets(mesh, k, axis_names, lshape) for k in range(mesh.size)]
    grids = ([kick_grid(lshape, global_shape, o) for o in offs]
             if apply_bc else None)
    neumann = _sharded_neumann(global_shape, mesh, axis_names)

    def fix(ups):
        """The ghost copy after a two-step step, on fresh blocks."""
        if not apply_bc:
            return ups
        if len(global_shape) == 3:
            return [neumann_bc_planar_3d(u, lshape, global_shape, o)
                    for u, o in zip(ups, offs)]
        views = neumann([u.view(u.shape[:-2] + lshape) for u in ups])
        return [v.reshape(u.shape) for u, v in zip(ups, views)]

    def step_of(m_parts, c_parts=None):
        desc = desc_of(c_parts)
        rhos = [nlse_density_planar(
            kind, m.to(torch.float32).reshape(m.shape[:-len(lshape)]
                                              + (Rl, nxl)).contiguous(),
            sigma1=sigma1, sigma2=sigma2, kappa=kappa) for m in m_parts]

        def ss2(ups):
            return nlse_mod.ss2_step_planar_sharded(ups, desc, rhos, dt,
                                                    m=krylov_m, grids=grids)

        if integrator == "ss2":
            return lambda ups, i: ss2(ups)

        def step(state, i):
            ups, ups_prev = state
            if i == 1:          # bootstrap: one SS2 step, u_prev := u
                return ss2(ups), ups
            if integrator == "gautschi":
                new, old = nlse_mod.gautschi_step_planar_sharded(
                    ups, ups_prev, desc, rhos, dt, m=krylov_m)
            else:
                new, old = nlse_mod.sewi_step_planar_sharded(
                    ups, ups_prev, desc, rhos, dt, m=krylov_m,
                    fuse_exp_sinc=integrator == "sewi_fused")
            return fix(new), old

        return step

    step_of.block = (Rl, nxl)
    step_of.lshape = lshape
    return step_of


def _generic_nlse(kind, global_shape, Lx, dt, mesh, axis_names, integrator,
                  sigma1, sigma2, kappa, krylov_m, rdtype, variant, apply_bc,
                  reorth, use_c):
    """lane_of(m_parts, c_parts) -> step(state, i) of ONE lane on the
    generic (complex) path, JAX's local_single and single_step
    (spatial.py:476-488, 754-780): a state is a sharded field of complex
    blocks (a pair of them for the two-step integrators, whose index 1 is
    the SS2 bootstrap), the matrix functions the sharded generic Lanczos
    (models/nlse.py with the mesh) on the plain sharded operator, then the
    where-mask ghost copy. m and c are the lane's real blocks. The path of
    complex128 and of reorth=False; plain torch, as JAX's is jnp."""
    if integrator not in ("ss2", "sewi", "sewi_fused", "gautschi"):
        raise ValueError(f"unknown NLSE integrator {integrator!r}")
    if kind not in NLSE_KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    global_shape = tuple(int(g) for g in global_shape)
    axis_names = tuple(axis_names)
    dx = 2.0 * Lx / (global_shape[-1] - 1)
    lshape = _block_of(global_shape, mesh, axis_names)
    if len(global_shape) == 3 and variant == "reference":
        _check_reference(lshape, global_shape, aniso=use_c)
    if use_c:
        aniso = _sharded_aniso(global_shape, dx, mesh, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, mesh, axis_names, variant,
                           rdtype)
    neumann = (_sharded_neumann(global_shape, mesh, axis_names) if apply_bc
               else (lambda us: us))
    kw = dict(m=krylov_m, reorth=reorth, mesh=mesh)
    if integrator == "gautschi":
        two_step = nlse_mod.gautschi_step
    else:
        two_step = partial(nlse_mod.sewi_step,
                           fuse_exp_sinc=integrator == "sewi_fused")

    def lane_of(m_parts, c_parts=None):
        if use_c:
            if c_parts is None:
                raise ValueError("use_c=True: the step takes the c field")
            cs = [c.to(rdtype) for c in c_parts]
            op = lambda us: aniso(us, cs)
        else:
            op = lap
        rhos = [nlse_density(kind, m.to(rdtype), sigma1=sigma1,
                             sigma2=sigma2, kappa=kappa) for m in m_parts]
        rho = lambda us: [r(u) for r, u in zip(rhos, us)]
        if integrator == "ss2":
            return lambda us, i: neumann(nlse_mod.ss2_step(us, op, rho, dt,
                                                           **kw))

        def step(state, i):
            us, us_prev = state
            if i == 1:
                new, old = nlse_mod.sewi_first_step(us, op, rho, dt, **kw)
            else:
                new, old = two_step(us, us_prev, op, rho, dt, **kw)
            return neumann(new), old

        return step

    lane_of.lshape = lshape
    return lane_of


def _lanes(lane_of, fields):
    """The step of lane_of over a batch, the lanes one after the other
    (models/evolve.lanes_in_turn; JAX vmaps its generic step, but a sharded
    Lanczos run's reductions span a lane's whole grid, so the lanes cannot
    share one): fields are the sharded (B, *block) m and c (c None without
    use_c)."""
    m_parts, c_parts = fields
    B = m_parts[0].shape[0]

    def pick(parts, b):
        return None if parts is None else [x[b] for x in parts]

    return lanes_in_turn([lane_of(pick(m_parts, b), pick(c_parts, b))
                          for b in range(B)])


def make_sharded_nlse_step(kind, global_shape, Lx, dt, mesh,
                           axis_names=("gy", "gx"), batch_axis=None,
                           sigma1=1.0, sigma2=-0.1, kappa=1.0,
                           krylov_m=10, dtype=torch.complex64,
                           variant="reference", apply_bc=True, reorth=True,
                           use_c=False):
    """An SS2 step over a spatially sharded (optionally also
    trajectory-batched) grid.

    Returns step(u_parts, m_parts) -> u_parts, or step(u_parts, m_parts,
    c_parts) with use_c=True (the finite-volume div(c grad u) with
    cross-shard face fluxes). Every argument is a sharded field
    (parallel/shards.shard): u is packed, (2,) + the local block of each
    shard, stacked (re, im); m and c are real local blocks. 3D grids take
    axis_names=("gz", "gy", "gx"). With `batch_axis` (a mesh axis that
    splits no grid dimension) u is (2, B, *grid) and m, c (B, *grid),
    sharded with shards.shard(..., batch_axis=batch_axis, batch_dim=1 for u
    and 0 for m and c): each batch index's grid sub-mesh steps its lanes,
    nothing crosses the batch axis. The state stays sharded from step to
    step; shards.gather makes it one global field. With apply_bc every step
    ends with the Neumann ghost copy; apply_bc=False skips it.

    complex64 with reorth=True takes the planar path of the JAX package
    (local_single_planar): the shard kernels, float32, every lane of a
    sub-mesh in one batched step (the closing kick does the ghost copy).
    complex128 and reorth=False take the generic path (local_single):
    complex blocks in the state's precision, the sharded generic Lanczos,
    the lanes in turn.
    """
    dtype = torch_dtype(dtype)
    rdtype = real_dtype_of(dtype)
    generic = dtype != torch.complex64 or not reorth
    if generic:
        blocks = _per_block(mesh, batch_axis, lambda sub: _generic_nlse(
            kind, global_shape, Lx, dt, sub, axis_names, "ss2", sigma1,
            sigma2, kappa, krylov_m, rdtype, variant, apply_bc, reorth,
            use_c))
    else:
        blocks = _per_block(mesh, batch_axis, lambda sub: _planar_nlse(
            kind, global_shape, Lx, dt, sub, axis_names, "ss2", sigma1,
            sigma2, kappa, krylov_m, variant, apply_bc, use_c))
    lshape = blocks[0][1].lshape
    lead = () if batch_axis is None else (-1,)

    def sub_step(step_of, us, ms, cs):
        if generic:
            zs = [torch.complex(u[0].to(rdtype), u[1].to(rdtype)) for u in us]
            if batch_axis is None:
                out = step_of(ms, cs)(zs, 1)
            else:
                out = _lanes(step_of, (ms, cs))(zs, 1)
            return [torch.stack([z.real, z.imag]) for z in out]
        # planar: ([B,] 2, R, nx) float32 blocks, the lanes first
        ups = [(u if batch_axis is None else u.movedim(1, 0)).to(
            torch.float32).reshape(lead + (2,) + step_of.block).contiguous()
            for u in us]
        out = step_of(ms, cs)(ups, 1)
        if batch_axis is None:
            return [o.reshape((2,) + lshape) for o in out]
        return [o.reshape(lead + (2,) + lshape).movedim(0, 1).contiguous()
                for o in out]

    def step(u_parts, m_parts, c_parts=None):
        out = [None] * mesh.size
        for ks, step_of in blocks:
            pick = lambda parts: (None if parts is None
                                  else [parts[k] for k in ks])
            for k, o in zip(ks, sub_step(step_of, pick(u_parts),
                                         pick(m_parts), pick(c_parts))):
                out[k] = o
        return out

    return step


def _realwave(kind, global_shape, Lx, dt, mesh, axis_names, integrator,
              krylov_m, rdtype, variant, apply_bc, reorth, use_c):
    """step_of(m_parts, c_parts) -> step((u, u_past), i) of a real-wave
    integrator on a sharded grid, on each shard's ([B,] *block) fields:
    float32 Gautschi through the shard kernels on -Lap (P=1, the sign
    flipped), all lanes in one batched step; a float64 or reorth=False
    Gautschi on the generic path (models/realwave.gautschi_step with the
    mesh, the sharded generic Lanczos of -Lap, JAX's rw.gautschi_step with
    axis_names), the lanes in turn; or SV on the plain sharded operator.
    Then the ghost copy, the sharded where-mask copy or, for a float32 3D
    field, bc3d in place on the fresh u_new at each shard's offsets
    (models/problems._real_neumann's rule)."""
    if kind not in REALWAVE_KINDS:
        raise ValueError(f"unknown real-wave kind {kind!r}")
    if integrator not in ("gautschi", "sv"):
        raise ValueError(f"unknown real-wave integrator {integrator!r}")
    generic = integrator == "gautschi" and (rdtype != torch.float32
                                            or not reorth)
    global_shape = tuple(int(g) for g in global_shape)
    axis_names = tuple(axis_names)
    dx = 2.0 * Lx / (global_shape[-1] - 1)
    lshape = _block_of(global_shape, mesh, axis_names)
    if len(global_shape) == 3 and variant == "reference":
        _check_reference(lshape, global_shape, aniso=use_c)
    g = realwave_g(kind)
    filt = rw.gautschi_filter(kind)
    offs = [offsets(mesh, k, axis_names, lshape) for k in range(mesh.size)]
    if integrator == "gautschi" and not generic:
        desc_of = _shard_desc(global_shape, dx, mesh, axis_names, variant,
                              use_c, lshape)
    elif use_c:
        aniso = _sharded_aniso(global_shape, dx, mesh, axis_names, variant)
    else:
        lap = _sharded_lap(global_shape, dx, mesh, axis_names, variant,
                           rdtype)
    neumann = _sharded_neumann(global_shape, mesh, axis_names)
    nd = len(global_shape)

    def fix(us):
        if not apply_bc:
            return us
        if nd == 3 and rdtype == torch.float32:
            R = lshape[0] * lshape[1]
            for u, o in zip(us, offs):
                neumann_bc_planar_3d(u.view(u.shape[:-3] + (1, R, lshape[2])),
                                     lshape, global_shape, o)
            return us
        return neumann(us)

    def op_of(c_parts):
        if not use_c:
            return lap
        if c_parts is None:
            raise ValueError("use_c=True: the step takes the c field")
        cs = [c.to(rdtype) for c in c_parts]
        return lambda us: aniso(us, cs)

    def generic_lane(m_parts, c_parts):
        op = op_of(c_parts)
        omega2 = lambda us: [-x for x in op(us)]

        def step(state, i):
            us, us_past = state
            new, old = rw.gautschi_step(us, us_past, omega2, m_parts, g, dt,
                                        m=krylov_m, filter_func=filt,
                                        reorth=reorth, mesh=mesh)
            return fix(new), old

        return step

    def step_of(m_parts, c_parts=None):
        ms = [m.to(rdtype) for m in m_parts]
        if generic:
            if ms[0].dim() == nd:
                return generic_lane(ms, c_parts)
            return _lanes(generic_lane, (ms, c_parts))
        if integrator == "gautschi":
            desc = desc_of(c_parts)
            desc = dict(desc, sign=-desc["sign"])

            def step(state, i):
                us, us_past = state
                new, old = rw.gautschi_step_sharded(
                    us, us_past, desc, ms, g, dt, m=krylov_m,
                    filter_func=filt)
                return fix(new), old

            return step
        op = op_of(c_parts)

        def step(state, i):
            us, us_past = state
            lu = op(us)
            return fix([2.0 * u - up + (dt * dt) * (a - mk * g(u))
                        for u, up, a, mk in zip(us, us_past, lu, ms)]), us

        return step

    step_of.lshape = lshape
    step_of.batched = not generic
    return step_of


def make_sharded_realwave_step(kind, global_shape, Lx, dt, mesh,
                               axis_names=("gy", "gx"), batch_axis=None,
                               integrator="gautschi", krylov_m=10,
                               dtype=torch.float32, variant="reference",
                               apply_bc=True, reorth=True, use_c=False):
    """A real-wave step (Gautschi or SV) on a spatially sharded grid.

    Returns step(u, u_past, m) -> (u_new, u), or step(u, u_past, m, c) with
    use_c=True (the finite-volume div(c grad u) with cross-shard face
    fluxes, the reference real-wave drivers' anisotropic operator,
    sg_single_solver.hpp:42-59). Every argument is a sharded field of local
    (*block) tensors (parallel/shards.shard), or (B, *grid) ones sharded
    with batch_axis (shards.shard(..., batch_axis=batch_axis)); 3D grids
    take axis_names=("gz", "gy", "gx"). A float32 Gautschi step runs
    through the shard kernels (both matrix functions on -Lap, the filter
    and the cosine from one Lanczos run), a float64 or reorth=False one on
    the generic path; SV applies the plain sharded operator in any real
    dtype. With batch_axis each batch index's grid sub-mesh steps its
    lanes.
    """
    rdtype = real_dtype_of(torch_dtype(dtype))
    blocks = _per_block(mesh, batch_axis, lambda sub: _realwave(
        kind, global_shape, Lx, dt, sub, axis_names, integrator, krylov_m,
        rdtype, variant, apply_bc, reorth, use_c))

    def step(u, u_past, m_parts, c_parts=None):
        new, old = [None] * mesh.size, [None] * mesh.size
        for ks, step_of in blocks:
            pick = lambda parts: (None if parts is None
                                  else [parts[k] for k in ks])
            n, o = step_of(pick(m_parts), pick(c_parts))(
                (pick(u), pick(u_past)), 1)
            for k, nk, ok in zip(ks, n, o):
                new[k], old[k] = nk, ok
        return new, old

    return step


def sharded_gradient(parts, dx, dim, mesh, axis_name, N):
    """np.gradient along one grid dimension `dim` (negative, counted from
    the end) sharded over `axis_name`: central differences inside, first
    order one-sided at the GLOBAL ends (N cells), the neighbours across a
    shard edge from its halo (JAX's sharded_gradient). Lists in, a list
    out."""
    n = parts[0].shape[dim]
    nxt = recv_from_next([u.narrow(dim, 0, 1) for u in parts], mesh,
                         axis_name)
    prv = recv_from_prev([u.narrow(dim, n - 1, 1) for u in parts], mesh,
                         axis_name)
    shape = [1] * (-dim)
    shape[0] = n
    out = []
    for k, u in enumerate(parts):
        gc = (mesh.axis_index(k, axis_name) * n
              + torch.arange(n, device=u.device).reshape(shape))
        up = torch.cat([u.narrow(dim, 1, n - 1), nxt[k]], dim=dim)
        dn = torch.cat([prv[k], u.narrow(dim, 0, n - 1)], dim=dim)
        grad = (up - dn) / (2.0 * dx)
        grad = torch.where(gc == 0, (up - u) / dx, grad)
        out.append(torch.where(gc == N - 1, (u - dn) / dx, grad))
    return out


def _lane_sums(parts, mesh, dV):
    """Each lane's sum over the grid of a sharded (B, *block) field: every
    shard's sum of each lane alone (models/evolve.lane_sums) times dV,
    psum'd in shard order."""
    return shards.psum([lane_sums(p) * dV for p in parts], mesh)[0]


def _tensor(x, dtype):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dtype)


def _batch_axis_traj(mesh, batch_axis, build):
    """The trajectory function of a (batch, *grid) mesh: build(sub-mesh)
    for each batch index, each run on its block of the batch's lanes
    (parallel/mesh.lane_blocks; JAX's P(batch_axis, ...) specs,
    spatial.py:782-787, 922-925), the outputs joined on the first shard's
    device. Each block keeps JAX's contract within it: its guard stops when
    every lane of the block has diverged, as each batch shard's loop does
    under shard_map. No batch axis: build(mesh) itself."""
    if batch_axis is None:
        return build(mesh)
    trajs = [t for _, t in _per_block(mesh, batch_axis, build)]

    def traj(*args):
        *fields, num_snapshots, snapshot_freq = args
        outs = [t(*[None if f is None else f[sl] for f in fields],
                  num_snapshots, snapshot_freq)
                for t, sl in zip(trajs, lane_blocks(len(fields[0]),
                                                    len(trajs)))]
        return tree_map(lambda *xs: torch.cat([x.to(mesh.devices[0])
                                               for x in xs]), *outs)

    traj.batched = trajs[0].batched
    return traj


def make_sharded_nlse_trajectory_fn(kind, global_shape, Lx, dt, mesh,
                                    axis_names=("gy", "gx"),
                                    batch_axis=None, integrator="ss2",
                                    sigma1=1.0, sigma2=-0.1, kappa=1.0,
                                    krylov_m=10, dtype=torch.complex64,
                                    variant="reference", apply_bc=True,
                                    reorth=True, use_c=True, guard=False,
                                    record_energy=False):
    """Builds traj(u0_packed, m, c, num_snapshots, snapshot_freq) on a
    spatially sharded grid, with the contract of
    pipeline/engine.make_nlse_trajectory_fn.

    u0_packed: (B, 2, *global_shape) real, stacked (real, imag); m, c:
    (B, *global_shape) real (c ignored with use_c=False); numpy arrays or
    tensors. Returns (B, S, 2, *global_shape) on the first shard's device;
    guard=True appends bad_at (B,) int32, record_energy=True a
    {"mass": (B, S)} series, both over the whole grid. complex64 with
    reorth=True takes the planar path of the JAX package (float32, ss2,
    sewi, sewi_fused or gautschi with the SS2 bootstrap at step 1), all B
    lanes in one batched sharded step; complex128 or reorth=False the
    generic path (JAX's single_step, spatial.py:754-780) in the state's
    precision, the lanes in turn (the `batched` attribute says which).
    `batch_axis` splits the lanes over that mesh axis, each batch index's
    grid sub-mesh running its block.
    """
    dtype = torch_dtype(dtype)
    return _batch_axis_traj(mesh, batch_axis, lambda sub: _nlse_traj(
        kind, global_shape, Lx, dt, sub, tuple(axis_names), integrator,
        sigma1, sigma2, kappa, krylov_m, dtype, variant, apply_bc, reorth,
        use_c, guard, record_energy))


def _nlse_traj(kind, global_shape, Lx, dt, mesh, axis_names, integrator,
               sigma1, sigma2, kappa, krylov_m, dtype, variant, apply_bc,
               reorth, use_c, guard, record_energy):
    """make_sharded_nlse_trajectory_fn on a grid-only mesh."""
    rdtype = real_dtype_of(dtype)
    generic = dtype != torch.complex64 or not reorth
    if generic:
        lane_of = _generic_nlse(kind, global_shape, Lx, dt, mesh, axis_names,
                                integrator, sigma1, sigma2, kappa, krylov_m,
                                rdtype, variant, apply_bc, reorth, use_c)
    else:
        step_of = _planar_nlse(kind, global_shape, Lx, dt, mesh, axis_names,
                               integrator, sigma1, sigma2, kappa, krylov_m,
                               variant, apply_bc, use_c)
    lshape = (lane_of if generic else step_of).lshape
    nd = len(global_shape)
    two_state = integrator != "ss2"
    dV = (2.0 * Lx / (global_shape[-1] - 1)) ** nd

    def first(state):
        return state[0] if two_state else state

    def observe(state):
        if generic:                                 # complex (B, *grid)
            return shards.gather(first(state), mesh, axis_names)
        return shards.gather([u.view(u.shape[:2] + lshape)
                              for u in first(state)], mesh, axis_names)

    def mass_of(state):
        if generic:
            return _lane_sums([torch.abs(u) ** 2 for u in first(state)],
                              mesh, dV)
        return _lane_sums([u * u for u in first(state)], mesh, dV)

    def traj(u0_packed, m, c, num_snapshots, snapshot_freq):
        ms = shards.shard(_tensor(m, rdtype if generic else torch.float32),
                          mesh, axis_names)
        cs = (shards.shard(_tensor(c, rdtype if generic else torch.float32),
                           mesh, axis_names) if use_c else None)
        if generic:
            u0 = _tensor(u0_packed, rdtype)
            ups = shards.shard(torch.complex(u0[:, 0], u0[:, 1]), mesh,
                               axis_names)
            step = _lanes(lane_of, (ms, cs))
        else:
            u0 = _tensor(u0_packed, torch.float32)
            ups = [u.reshape((u0.shape[0], 2) + step_of.block) for u in
                   shards.shard(u0, mesh, axis_names)]
            step = step_of(ms, cs)
        state0 = (ups, ups) if two_state else ups
        scalars = {"mass": mass_of} if record_energy else None
        snaps, bad_at, series = evolve_lanes(step, state0, num_snapshots,
                                             snapshot_freq, observe, guard,
                                             scalars)
        out = snaps.movedim(0, 1)
        if generic:                                 # pack (re, im)
            out = torch.stack([out.real, out.imag], dim=2)
        if not guard:
            return out
        return (out, bad_at) + ((series,) if record_energy else ())

    traj.batched = not generic
    return traj


def make_sharded_realwave_trajectory_fn(kind, global_shape, Lx, dt, mesh,
                                        axis_names=("gy", "gx"),
                                        batch_axis=None,
                                        integrator="gautschi", krylov_m=10,
                                        dtype=torch.float32,
                                        variant="reference", apply_bc=True,
                                        reorth=True, use_c=True,
                                        guard=False, record_energy=False):
    """Builds traj(u0, v0, m, c, num_snapshots, snapshot_freq) on a
    spatially sharded grid, with the contract of
    pipeline/engine.make_realwave_trajectory_fn: (B, *global_shape) inputs,
    (u_traj, v_traj) each (B, S, *global_shape) with v = (u - u_past)/dt
    (kg_driver.cpp:112); guard appends bad_at (B,) int32, record_energy an
    {"energy": (B, S)} series (the energy of the unsharded engine, its
    gradients central inside and one-sided at the grid's ends across the
    shards' halos). Gautschi in float32 through the shard kernels, all B
    lanes in one batched sharded step; float64 or reorth=False Gautschi on
    the generic path, the lanes in turn; SV in any real dtype, batched.
    stochastic phi-4 is not grid-shardable (JAX's ValueError). `batch_axis`
    splits the lanes over that mesh axis, as the NLSE engine does.
    """
    if kind == "stochastic_phi4":
        raise ValueError("stochastic_phi4 is not supported on sharded "
                         "grids; use pipeline/engine (batch sharding)")
    rdtype = real_dtype_of(torch_dtype(dtype))
    return _batch_axis_traj(mesh, batch_axis, lambda sub: _realwave_traj(
        kind, global_shape, Lx, dt, sub, tuple(axis_names), integrator,
        krylov_m, rdtype, variant, apply_bc, reorth, use_c, guard,
        record_energy))


def _realwave_traj(kind, global_shape, Lx, dt, mesh, axis_names, integrator,
                   krylov_m, rdtype, variant, apply_bc, reorth, use_c, guard,
                   record_energy):
    """make_sharded_realwave_trajectory_fn on a grid-only mesh."""
    step_of = _realwave(kind, global_shape, Lx, dt, mesh, axis_names,
                        integrator, krylov_m, rdtype, variant, apply_bc,
                        reorth, use_c)
    global_shape = tuple(int(g) for g in global_shape)
    nd = len(global_shape)
    dx = 2.0 * Lx / (global_shape[-1] - 1)
    potential = realwave_potential(kind)

    def observe(state):
        us, us_past = state
        return (shards.gather(us, mesh, axis_names),
                shards.gather([(u - up) / dt for u, up in zip(us, us_past)],
                              mesh, axis_names))

    def energy_of(state):
        us, us_past = state
        grad2 = None
        for d, (name, N) in enumerate(zip(axis_names, global_shape)):
            gr = sharded_gradient(us, dx, d - nd, mesh, name, N)
            grad2 = ([x * x for x in gr] if grad2 is None
                     else [a + x * x for a, x in zip(grad2, gr)])
        dens = [0.5 * ((u - up) / dt) ** 2 + 0.5 * g2 + potential(u)
                for u, up, g2 in zip(us, us_past, grad2)]
        return _lane_sums(dens, mesh, dx ** nd)

    def traj(u0, v0, m, c, num_snapshots, snapshot_freq):
        u0 = _tensor(u0, rdtype)
        past = u0 - dt * _tensor(v0, rdtype)       # u_past = u0 - dt v0
        state0 = (shards.shard(u0, mesh, axis_names),
                  shards.shard(past, mesh, axis_names))
        ms = shards.shard(_tensor(m, rdtype), mesh, axis_names)
        cs = (shards.shard(_tensor(c, rdtype), mesh, axis_names)
              if use_c else None)
        scalars = {"energy": energy_of} if record_energy else None
        (u_s, v_s), bad_at, series = evolve_lanes(
            step_of(ms, cs), state0, num_snapshots, snapshot_freq, observe,
            guard, scalars)
        out = (u_s.movedim(0, 1), v_s.movedim(0, 1))
        if not guard:
            return out
        return out + (bad_at,) + ((series,) if record_energy else ())

    traj.batched = step_of.batched
    return traj
