"""The sharded Lanczos loops and matrix function (port of the sharded
branch of nlsolvers_tpu/ops/pallas/lanczos2d.lanczos_planar and of
lanczos3d_pipe.lanczos_twopass3d_y_sharded).

A shard descriptor (SHARD_KINDS, built by parallel/spatial.py) holds the
mesh and the global grid; u is a sharded field (parallel/shards.py) of each
shard's planar (P, R, nx) block, the merged (P, lnz*lny, nx) view in 3D.
Per iteration the deferred-norm CGS loop builds each shard's halos (and,
for c(x), once per call its padded face weights), launches the shard pass1
kernel (ops/cuda/lanczos2d.pass1_shard2d, lanczos3d.pass1_shard3d) and K4
pass2 on every shard, and takes ONE packed psum of the dots; the final sum
is K3 combine on every shard with one coefficient set. The kernel wrappers
see only one shard's local tensors and a local descriptor without the mesh.

A batch of B trajectories (the sharded datagen engine's lanes, JAX's vmap
of the step inside shard_map) is a sharded field of (B, P, R, nx) blocks,
with the lanes' c(x) (B, ...) per shard: every shard's halos of all lanes
are built in one op, each kernel is one launch over the lanes, the psum
packs every lane's dots, and the scalar recurrence and the eigh run on
(B, ...) tensors. Every reduction is the kernels' (the start norm too:
pass2's norm-only form), so lane b gets the bits of the loop run on lane b
alone.
"""

import math

import torch

from nlsolvers_tpu_torch.ops.cuda.lanczos2d import (MAX_M, combine,
                                                    combine_coefficients,
                                                    pass1_shard2d, safe_inv)
from nlsolvers_tpu_torch.ops.cuda.lanczos3d import pass1_shard3d, pass2
from nlsolvers_tpu_torch.ops.operators import block_coords
from nlsolvers_tpu_torch.parallel import shards

__all__ = ["SHARD_KINDS", "supported_shard", "lanczos_sharded",
           "matfunc_apply_sharded", "matfunc_apply_sharded_multi"]

SHARD_KINDS_2D = ("shard2d", "shard2d_aniso")
SHARD_KINDS_3D = ("shard3d", "shard3d_aniso")
SHARD_KINDS = SHARD_KINDS_2D + SHARD_KINDS_3D


def supported_shard(desc, u_shape, dtype):
    """Can the shard kernels run this descriptor? `u_shape` is the LOCAL
    block, (lny, lnx) or (lnz, lny, lnx). Any block with sides >= 2 runs
    (the TPU's lane and sublane gates do not apply); the 3D reference
    variant needs the z and y axes unsplit, as in the JAX package."""
    kind = desc.get("kind")
    if (kind not in SHARD_KINDS or "mesh" not in desc
            or dtype not in (torch.complex64, torch.float32)):
        return False
    if kind.endswith("aniso") and desc.get("c") is None:
        return False
    if kind != "shard2d_aniso" and desc.get("variant") not in ("reference",
                                                              "clean"):
        return False
    if kind in SHARD_KINDS_2D:
        return len(u_shape) == 2 and min(u_shape) >= 2
    return (len(u_shape) == 3 and min(u_shape) >= 2
            and tuple(u_shape[:2]) == (desc.get("lnz"), desc.get("lny"))
            and (desc["variant"] != "reference"
                 or tuple(u_shape[:2]) == (desc["NZ"], desc["NY"])))


def _deferred_norm_cgs(u, m, chat, mesh, pass1):
    """The sharded deferred-norm CGS loop (the JAX package's
    _deferred_norm_cgs), shared by the 2D and 3D shard loops: ONE psum per
    iteration plus one at the end.

    The recurrence runs on UNNORMALIZED columns: pass1(j, scal, W) applies
    w = (A/chat) W_j with a fixed Gershgorin bound chat >= ||A|| (so column
    norms stay bounded) and no three-term subtraction, fused with each
    shard's dots <W_i, w>, and returns both as lists over the shards; K4
    pass2 on every shard subtracts the CGS projections and returns each
    shard's ||W_{j+1}||^2, which rides the NEXT iteration's psum. So every
    global norm is exact, one psum late, and T comes from
    exact Rayleigh quotients, alpha_j = chat <W_j, A~ W_j> / ||W_j||^2, and
    exact norm ratios, beta_j = chat sqrt(||W_{j+1}||^2 / ||W_j||^2), with
    zero-norm guards. u and every W_i are sharded fields (lists over the
    mesh's shards); the scalars live on the first shard's device, each sum
    taken once in shard order (shards.psum) and handed to every shard, so
    every shard sees the same T. With a batch every scalar carries the
    lanes' leading axis (chat too)."""
    zero = torch.zeros_like(chat)
    scal = shards.broadcast(
        torch.stack([1.0 / chat, zero], dim=-1)[..., None, :].contiguous(),
        mesh)
    W = [u]
    nsq_loc = _local_norms(u, mesh)               # local ||W_0||^2
    nsqs = []                                     # exact global ||W_i||^2
    at = []                                       # alpha-tilde
    for j in range(m - 1):
        w, raw = pass1(j, scal, W)
        packed = shards.psum(
            [torch.cat([r, torch.stack([n, torch.zeros_like(n)],
                                       dim=-1)[..., None, :]], dim=-2)
             for r, n in zip(raw, nsq_loc)], mesh)[0]
        nsqs.append(packed[..., j + 1, 0])
        invn = torch.stack([safe_inv(n) for n in nsqs], dim=-1)
        q = invn[..., :, None] * packed[..., :j + 1, :]   # CGS coefficients
        at.append(q[..., j, 0])
        qs = shards.broadcast(q, mesh)
        wn, nsq2 = map(list, zip(*shards.per_shard(
            mesh, lambda k: pass2(qs[k], w[k], [c[k] for c in W]))))
        nsq_loc = [n[..., 0, 0] for n in nsq2]
        W.append(wn)
    nsqs.append(shards.psum(nsq_loc, mesh)[0])    # the last column's norm
    s = [safe_inv(torch.sqrt(n)) for n in nsqs]
    beta0 = torch.sqrt(nsqs[0])
    alphas = [chat * a for a in at]
    one = torch.ones_like(chat)
    betas = [chat * torch.sqrt(torch.where(
        nsqs[j] > 0, nsqs[j + 1] / torch.where(nsqs[j] > 0, nsqs[j], one),
        zero)) for j in range(m - 1)]
    return W, s, alphas, betas, beta0


def _local_norms(u, mesh):
    """Each shard's ||u||^2 per lane, from pass2's norm-only form: the
    kernels' reduction, so a lane's norm has the same bits in a batch and
    alone."""
    return [n[..., 0, 0] for _, n in shards.per_shard(
        mesh, lambda k: pass2(None, u[k], []))]


def _amax(x):
    """Largest entry of each lane's (ny, nx) plane: exact, so the same in a
    batch and alone."""
    return x.amax(dim=(-2, -1))


def _aniso_weights_2d(desc, ny, nx, lead):
    """Each shard's padded face weights of the sharded div(c grad u), the
    JAX package's wxp, wyp, wxl, wy_top (lanczos2d.py:1199-1218): wx and wy
    ([B,] ny, nx) hold the +x and +y faces, the last column and row the
    cross-shard ones (0 at the domain's edge); wxl ([B,] ny) and wyh
    ([B,] nx) the faces left of column 0 and above row 0. `lead` is the
    batch's leading axes, () for one trajectory."""
    mesh, ay, ax = desc["mesh"], desc["ay"], desc["ax"]
    c = [ck.to(torch.float32).reshape(lead + (ny, nx)) for ck in desc["c"]]
    c_rcol = shards.recv_from_next([ck[..., :1] for ck in c], mesh, ax)
    c_brow = shards.recv_from_next([ck[..., :1, :] for ck in c], mesh, ay)
    c_lcol = shards.recv_from_prev([ck[..., -1:] for ck in c], mesh, ax)
    c_trow = shards.recv_from_prev([ck[..., -1:, :] for ck in c], mesh, ay)
    out = []
    for k, ck in enumerate(c):
        gy, gx = block_coords(shards.offsets(mesh, k, (ay, ax), (ny, nx)),
                              (ny, nx), ck.device)
        c_r = torch.cat([ck[..., 1:], c_rcol[k]], dim=-1)
        c_b = torch.cat([ck[..., 1:, :], c_brow[k]], dim=-2)
        out.append(dict(
            wx=torch.where(gx == desc["NX"] - 1, 0.0, 0.5 * (ck + c_r)),
            wy=torch.where(gy == desc["NY"] - 1, 0.0, 0.5 * (ck + c_b)),
            wxl=torch.where(gx[0, :1] == 0, 0.0, 0.5 * (
                c_lcol[k][..., 0] + ck[..., 0])).contiguous(),
            wyh=torch.where(gy[:1, 0] == 0, 0.0, 0.5 * (
                c_trow[k][..., 0, :] + ck[..., 0, :])).contiguous()))
    return out


def _halos_2d(wj, mesh, ay, ax):
    """Each shard's (yh, xh) of the sharded field wj: the rows above and
    below the block ([B,] P, 2, nx) and the columns left and right of it
    ([B,] P, 2, ny), from the neighbours along ay and ax, zeros at the
    domain's edge; every lane's in the same ops."""
    top = shards.recv_from_prev([w[..., -1, :] for w in wj], mesh, ay)
    bot = shards.recv_from_next([w[..., 0, :] for w in wj], mesh, ay)
    lft = shards.recv_from_prev([w[..., -1] for w in wj], mesh, ax)
    rgt = shards.recv_from_next([w[..., 0] for w in wj], mesh, ax)
    return ([torch.stack([a, b], dim=-2) for a, b in zip(top, bot)],
            [torch.stack([a, b], dim=-2) for a, b in zip(lft, rgt)])


def _lanczos_shard2d(u, desc, m):
    """The sharded 2D loop: pass1_shard2d and pass2 on every shard, the
    deferred-norm CGS loop. chat is 8 |scale| (iso) or the pmax of
    4 (max wx + max wy) |scale| over the shards (aniso), per lane."""
    mesh, ay, ax = desc["mesh"], desc["ay"], desc["ax"]
    lead = tuple(u[0].shape[:-3])
    ny, nx = u[0].shape[-2:]
    scale = float(desc["scale"])
    base = dict(kind=desc["kind"], NY=desc["NY"], NX=desc["NX"], scale=scale,
                sign=desc["sign"], variant=desc["variant"])
    local = []
    for k in range(mesh.size):
        y0, x0 = shards.offsets(mesh, k, (ay, ax), (ny, nx))
        local.append(dict(base, y0=y0, x0=x0))
    if desc["kind"] == "shard2d_aniso":
        wts = _aniso_weights_2d(desc, ny, nx, lead)
        for ld, wt in zip(local, wts):
            ld.update(wt)
        ghat = shards.pmax([4.0 * (_amax(wt["wx"]) + _amax(wt["wy"]))
                            for wt in wts], mesh)[0]
        chat = (ghat * abs(scale)).to(torch.float32)
    else:
        # filled on the device: a host scalar copied over syncs the host
        chat = torch.full(lead, 8.0 * abs(scale), dtype=torch.float32,
                          device=u[0].device)

    def p1(j, scal, W):
        yh, xh = _halos_2d(W[j], mesh, ay, ax)
        return map(list, zip(*shards.per_shard(mesh, lambda k: pass1_shard2d(
            scal[k], W[j][k], [c[k] for c in W[:j]], yh[k], xh[k],
            local[k]))))

    return _deferred_norm_cgs(u, m, chat, mesh, p1)


def _aniso_weights_3d(desc, nz, ny, nx, plane_splice, lead):
    """Each shard's padded face weights of the sharded 3D div(c grad u) on
    the merged (R, nx) view, the JAX package's wxp, wyp, wzp, wxl, wy_top
    and wzh (lanczos2d.py:1292-1328): wx, wy, wz the +x, +y, +z faces (the
    last column, each plane's last row (clean) and the last plane cross
    shards; 0 at the domain's edge); wxl (R) the faces left of column 0; wyh
    (lnz, nx) the faces above each plane's row 0, from the ay neighbour
    (clean) or the merged-view seam (reference, unsplit z and y); wzh
    (ny, nx) the faces below plane 0. Each with the batch's leading axes
    `lead` ((): one trajectory)."""
    mesh, az, ay, ax = desc["mesh"], desc["az"], desc["ay"], desc["ax"]
    NZ, NY, NX = desc["NZ"], desc["NY"], desc["NX"]
    R = nz * ny
    c = [ck.to(torch.float32).reshape(lead + (nz, ny, nx))
         for ck in desc["c"]]
    c_rcol = shards.recv_from_next([ck[..., :1] for ck in c], mesh, ax)
    c_lcol = shards.recv_from_prev([ck[..., -1] for ck in c], mesh, ax)
    c_brow = shards.recv_from_next([ck[..., :1, :] for ck in c], mesh, ay)
    c_trow = shards.recv_from_prev([ck[..., -1, :] for ck in c], mesh, ay)
    c_znext = shards.recv_from_next([ck[..., :1, :, :] for ck in c], mesh,
                                    az)
    c_zprev = shards.recv_from_prev([ck[..., -1, :, :] for ck in c], mesh,
                                    az)
    out = []
    for k, ck in enumerate(c):
        offs = shards.offsets(mesh, k, (az, ay, ax), (nz, ny, nx))
        z0, y0, x0 = offs
        gz, gy, gx = block_coords(offs, (nz, ny, nx), ck.device)
        cm = ck.reshape(lead + (R, nx))
        wx = torch.where(gx == NX - 1, 0.0, 0.5 * (
            ck + torch.cat([ck[..., 1:], c_rcol[k]], dim=-1)))
        wz = torch.where(gz == NZ - 1, 0.0, 0.5 * (
            ck + torch.cat([ck[..., 1:, :, :], c_znext[k]], dim=-3)))
        wxl = 0.5 * (c_lcol[k].reshape(lead + (R,)) + cm[..., 0])
        wzh = 0.5 * (c_zprev[k] + ck[..., 0, :, :])
        if plane_splice:
            wy = torch.where(gy == NY - 1, 0.0, 0.5 * (
                ck + torch.cat([ck[..., 1:, :], c_brow[k]], dim=-2))
            ).reshape(lead + (R, nx))
            wyh = 0.5 * (c_trow[k] + ck[..., 0, :])
            if y0 == 0:
                wyh = torch.zeros_like(wyh)
        else:
            zrow = torch.zeros_like(cm[..., :1, :])
            wy = 0.5 * (cm + torch.cat([cm[..., 1:, :], zrow], dim=-2))
            wy[..., -1, :] = 0.0
            wyh = torch.cat([zrow, wy.view(lead + (nz, ny, nx))[
                ..., :-1, -1, :]], dim=-2)
        out.append(dict(
            wx=wx.reshape(lead + (R, nx)).contiguous(), wy=wy.contiguous(),
            wz=wz.reshape(lead + (R, nx)).contiguous(),
            wxl=(torch.zeros_like(wxl) if x0 == 0 else wxl).contiguous(),
            wyh=wyh.contiguous(),
            wzh=(torch.zeros_like(wzh) if z0 == 0 else wzh).contiguous()))
    return out


def _halos_3d(wj, mesh, axes, nz, ny, plane_splice):
    """Each shard's (yh, zh, xh) of the sharded field wj on the merged
    view: the y halo rows of every local plane (from the ay neighbours under
    "clean"; the merged-view seam rows, z-shifted edge rows with zeros at
    the ends, under "reference"), the z halo planes from the az neighbours
    and the x halo columns from the ax neighbours, zeros at the domain's
    edge; every lane's in the same ops."""
    az, ay, ax = axes
    lead = tuple(wj[0].shape[:-3])
    P, R, nx = wj[0].shape[-3:]
    w3 = [w.view(lead + (P, nz, ny, nx)) for w in wj]
    if plane_splice:
        ytop = shards.recv_from_prev([w[..., -1, :] for w in w3], mesh, ay)
        ybot = shards.recv_from_next([w[..., 0, :] for w in w3], mesh, ay)
    else:
        zrow = torch.zeros_like(w3[0][..., :1, 0, :])
        ytop = [torch.cat([zrow, w[..., :-1, -1, :]], dim=-2) for w in w3]
        ybot = [torch.cat([w[..., 1:, 0, :], zrow], dim=-2) for w in w3]
    zht = shards.recv_from_prev([w[..., -1, :, :] for w in w3], mesh, az)
    zhb = shards.recv_from_next([w[..., 0, :, :] for w in w3], mesh, az)
    lft = shards.recv_from_prev([w[..., -1] for w in wj], mesh, ax)
    rgt = shards.recv_from_next([w[..., 0] for w in wj], mesh, ax)

    def pair(a, b, dim):
        return [torch.stack([x, y], dim=dim) for x, y in zip(a, b)]

    return list(zip(pair(ytop, ybot, -3), pair(zht, zhb, -3),
                    pair(lft, rgt, -2)))


def _lanczos_shard3d(u, desc, m):
    """The sharded 3D loop (the JAX package's lanczos_twopass3d_y_sharded):
    the deferred-norm CGS with pass1_shard3d and pass2 on every
    shard. u is a sharded field of merged ([B,] P, lnz*lny, nx) blocks.
    chat is 12 |scale| (iso) or the pmax of 4 (max wx + max wy + max wz)
    |scale| over the shards (aniso), per lane."""
    mesh = desc["mesh"]
    axes = (desc["az"], desc["ay"], desc["ax"])
    lead = tuple(u[0].shape[:-3])
    nz, ny, nx = desc["lnz"], desc["lny"], u[0].shape[-1]
    plane_splice = desc["variant"] != "reference"
    scale = float(desc["scale"])
    base = dict(kind=desc["kind"], NZ=desc["NZ"], NY=desc["NY"],
                NX=desc["NX"], lnz=nz, lny=ny, scale=scale, sign=desc["sign"],
                variant=desc["variant"])
    local = [dict(base, **dict(zip(("z0", "y0", "x0"), shards.offsets(
        mesh, k, axes, (nz, ny, nx))))) for k in range(mesh.size)]
    if desc["kind"] == "shard3d_aniso":
        wts = _aniso_weights_3d(desc, nz, ny, nx, plane_splice, lead)
        for ld, wt in zip(local, wts):
            ld.update(wt)
        ghat = shards.pmax([4.0 * (_amax(wt["wx"]) + _amax(wt["wy"])
                                   + _amax(wt["wz"])) for wt in wts], mesh)[0]
        chat = (ghat * abs(scale)).to(torch.float32)
    else:
        chat = torch.full(lead, 12.0 * abs(scale), dtype=torch.float32,
                          device=u[0].device)

    def p1(j, scal, W):
        hal = _halos_3d(W[j], mesh, axes, nz, ny, plane_splice)
        return map(list, zip(*shards.per_shard(mesh, lambda k: pass1_shard3d(
            scal[k], W[j][k], [c[k] for c in W[:j]], *hal[k], local[k]))))

    return _deferred_norm_cgs(u, m, chat, mesh, p1)


def lanczos_sharded(u, desc, m):
    """lanczos_planar for a shard descriptor: u and every column of W are
    sharded fields of planar ([B,] P, R, nx) blocks; the scalars are one set
    (per lane), on the first shard's device. Returns (W, s, alpha, beta,
    beta0) as lanczos_planar."""
    P, R, nx = u[0].shape[-3:]
    kind = desc["kind"]
    lshape = ((desc.get("lnz"), desc.get("lny"), nx)
              if kind in SHARD_KINDS_3D else (R, nx))
    if (not supported_shard(desc, lshape, torch.float32)
            or math.prod(lshape[:-1]) != R or u[0].dim() not in (3, 4)
            or any(x.shape != u[0].shape for x in u)
            or len(u) != desc["mesh"].size):
        raise NotImplementedError(
            f"the shard kernels do not take a {kind} descriptor for "
            f"{len(u)} blocks of {tuple(u[0].shape)}")
    if m > MAX_M:
        raise ValueError(f"Krylov m={m} exceeds the kernels' {MAX_M}")
    if m == 1:
        beta0 = torch.sqrt(shards.psum(_local_norms(u, desc["mesh"]),
                                       desc["mesh"])[0])
        return [u], [safe_inv(beta0)], [], [], beta0
    if kind in SHARD_KINDS_3D:
        return _lanczos_shard3d(u, desc, m)
    return _lanczos_shard2d(u, desc, m)


def matfunc_apply_sharded_multi(u, desc, specs, m):
    """[f(t * sign*scale*L) u for (t, f) in specs] for a shard descriptor,
    from ONE sharded Lanczos run and one K3 combine per shard with the
    same coefficients: u and each output are sharded fields of planar
    ([B,] P, R, nx) blocks."""
    W, s, alphas, betas, beta0 = lanczos_sharded(u, desc, m)
    q = combine_coefficients(s, alphas, betas, beta0, specs, m)
    qs = shards.broadcast(q, desc["mesh"])
    outs = shards.per_shard(desc["mesh"], lambda k: combine(
        qs[k], [c[k] for c in W]))
    return [list(o) for o in zip(*outs)]


def matfunc_apply_sharded(u, desc, t, func, m):
    """y = f(t * sign*scale*L) u for a shard descriptor: one spec of
    matfunc_apply_sharded_multi."""
    return matfunc_apply_sharded_multi(u, desc, ((t, func),), m)[0]
