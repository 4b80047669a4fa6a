"""Fused Lanczos kernels for the 2D stencil operators: the 5-point no-flux
Laplacian (iso2d) and the finite-volume div(c grad u) (aniso2d).

Port of the iso2d and aniso2d parts of nlsolvers_tpu/ops/pallas/lanczos2d.py.
State is PLANAR float32: a complex field is (2, ny, nx) (re, im planes), a
real field (1, ny, nx). Krylov columns W_i are kept UNNORMALIZED with their inverse
norms s_i tracked as scalars, so normalization folds into the next matvec.

The entry points (supported_desc, lanczos_planar, matfunc_apply_planar*)
also serve the 3D kinds, whose loop is ops/cuda/lanczos3d.py (a 3D batch
too).

Hand-written CUDA kernels (csrc/lanczos2d.cu) carry the 2D loop; each has
its plain PyTorch version beside it and a launch counter on its wrapper:

  pass1_iso2d   / pass1_iso2d_ref     replaces _pass1_call (mode iso2d)
  pass1_aniso2d / pass1_aniso2d_ref   replaces _pass1_call (mode aniso2d)
  pipe_iso2d    / pipe_iso2d_ref      replaces _pipe_call (mode iso2d)
  pipe_aniso2d  / pipe_aniso2d_ref    replaces _pipe_call (mode aniso2d)
  combine       / combine_ref         replaces _combine_call
  iter_step     / iter_ref            replaces _iter_call (modes iso2d,
                                      aniso2d, iso3d): the opt-in fused
                                      iteration (config.fused_iter)
  pass1_shard2d / pass1_shard2d_ref   replaces _pass1_call (modes shard2d,
                                      shard2d_aniso): pass1 on one shard's
                                      block of a sharded 2D grid

The iso and aniso wrappers launch one pass1 and one pipe kernel with the
operator as a template policy; each wrapper counts its own launches.

K1/K1', K2/K2', K3, K5 and the shard pass1 also take a batch: fields
(B, P, ny, nx) with a leading lane axis, scalars (B, ...) and, for the
aniso operator, face weights (B, ny, nx)
(operators.batched_aniso_laplacian_2d; a shard's halos and edge weights
with a leading B too), the form that jax.vmap gives the Pallas kernels in
the JAX package's datagen engine (and in its sharded engines, inside
shard_map). A batch is ONE launch (the lane is a grid index), and lane
b of it gives the bits of the unbatched launch on lane b: the kernel walks
each lane's field with the unbatched block map and reduces each lane's
partial sums in the unbatched order. K5 takes a batch too: its
cooperative grid stays one lane's, and each block walks its segments in
every lane between the same grid syncs (csrc/lanczos2d.cu). The plain
versions take the same leading axis, vectorised over it. `lanczos_planar`
runs a batch through the loop it picks for one lane, with the scalar
recurrence on (B, ...) tensors and one batched eigh
(ops/krylov.tridiag_eigh).

A wrapper launches its kernel for a CUDA tensor under config.kernel_mode
"auto" and raises if the kernel cannot run; it takes the plain version for a
CPU tensor, or under "off". What bounds the kernels, and what their design
does about it, is in the header of csrc/lanczos2d.cu.

The scalar recurrence between the kernels (_lanczos_pipe) runs as 0-d/1-d
torch ops on the device, with no .item(); the one host sync left in a
matrix function is torch.linalg.eigh's (PERF.md). `lanczos_planar` picks
the loop: the pipe (2D; 3D with config.pipeline_3d), the two-pass loop (3D)
or, with config.fused_iter, the two-pass loop with one K5 per iteration.
The sharded loop that drives pass1_shard2d is parallel/lanczos.py; the
wrapper itself takes one shard's local tensors.
"""

import ctypes
import functools

import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops import krylov
from nlsolvers_tpu_torch.ops.cuda import _build
from nlsolvers_tpu_torch.ops.operators import block_coords, boundary_diagonal

__all__ = ["matvec_descriptor", "supported_desc", "lanczos_planar",
           "matfunc_apply_planar", "matfunc_apply_planar_multi",
           "combine_coefficients",
           "pass1_iso2d", "pass1_iso2d_ref", "pass1_aniso2d",
           "pass1_aniso2d_ref", "pipe_iso2d", "pipe_iso2d_ref",
           "pipe_aniso2d", "pipe_aniso2d_ref", "combine", "combine_ref",
           "iter_step", "iter_ref", "iter_plan", "iter_form",
           "pass1_shard2d", "pass1_shard2d_ref",
           "MAX_M", "MAX_SPECS", "KINDS_3D",
           "FUSED_ITER_BYTES"]

# Longest basis (Krylov m) and most matrix functions per combine the kernels
# take: csrc/lanczos2d.cu's MAXCOLS and KMAX, checked when it is loaded.
MAX_M = 32
MAX_SPECS = 4

# Largest field (P * rows * nx float32 bytes) that config.fused_iter takes
# through K5, the JAX package's rule (lanczos2d.py:1387-1390): the w
# intermediate of one iteration then fits in the H100's 50 MB L2.
FUSED_ITER_BYTES = 32 * 2**20

# K5's geometry (csrc/lz_iter.cuh): rows of STRIP_COLS-column strips, split
# evenly over a grid of at most COOP_PER_SM blocks per SM; in the global
# form the dynamic shared memory holds one w row per warp (ITER_WARPS).
STRIP_COLS = 128
COOP_PER_SM = 2
ITER_WARPS = 8


def matvec_descriptor(kind, shape, scale, sign=1.0, variant="reference"):
    """Static description of a stencil operator the fused kernels implement:
    kind "laplacian_2d" (5-point no-flux, reference or clean diagonal);
    `sign` multiplies the whole operator."""
    ny, nx = shape
    return dict(kind=kind, ny=int(ny), nx=int(nx), scale=float(scale),
                sign=float(sign), variant=variant)


# descriptor kinds whose Lanczos loop is the 2D one below, and those whose
# loop is ops/cuda/lanczos3d.py
KINDS_2D = ("laplacian_2d", "aniso_laplacian_2d")
KINDS_3D = ("laplacian_3d", "aniso_laplacian_3d")


def _weight_ok(w, desc):
    """A face-weight plane (ny, nx), or a batch's planes (B, ny, nx)."""
    return (isinstance(w, torch.Tensor) and w.dtype == torch.float32
            and w.is_contiguous() and w.dim() in (2, 3)
            and tuple(w.shape[-2:]) == (desc["ny"], desc["nx"]))


def supported_desc(desc, u_shape, dtype):
    """Can the fused path run this operator/field combination? `u_shape` is
    the grid, (ny, nx) or (nz, ny, nx); the 3D kinds are lanczos3d's. The
    kernels mask ragged edges, so any grid with sides >= 3 qualifies. The
    aniso weights must be contiguous float32 (ny, nx) tensors, or (B, ny,
    nx) for a batch; a wrapper given weights on another device than the
    field raises."""
    if desc is not None and desc.get("kind") in KINDS_3D:
        from nlsolvers_tpu_torch.ops.cuda import lanczos3d
        return lanczos3d.supported_desc(desc, u_shape, dtype)
    if desc is None or desc.get("kind") not in KINDS_2D:
        return False
    if desc["kind"] == "laplacian_2d":
        if desc.get("variant") not in ("reference", "clean"):
            return False
    elif not all(_weight_ok(desc.get(k), desc) for k in ("wx", "wy")):
        return False
    if tuple(u_shape) != (desc["ny"], desc["nx"]):
        return False
    if dtype not in (torch.complex64, torch.float32):
        return False
    return desc["ny"] >= 3 and desc["nx"] >= 3


# ------------------------------------------------------------ kernel plumbing

_lib_cache = []


def _lib():
    if _lib_cache:
        return _lib_cache[0]
    lib = _build.library("lanczos2d")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pp = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
            ("lz_num_blocks", [i32, i32]),
            ("lz_pass1_blocks", []),
            ("lz_pipe_blocks", []),
            ("lz_max_cols", []),
            ("lz_max_specs", []),
            ("lz_pass1_iso2d",
             [i32, i32, vp, vp, pp, i32, vp, vp, vp, i32, i32, f32, i32,
              vp]),
            ("lz_pass1_aniso2d",
             [i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, vp, i32, i32, f32,
              vp]),
            ("lz_pipe_iso2d",
             [i32, i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, i32, i32, f32,
              i32, vp]),
            ("lz_pipe_aniso2d",
             [i32, i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, vp, vp, i32,
              i32, f32, vp]),
            ("lz_combine", [i32, i32, vp, pp, i32, i32, pp, i32, i32, vp]),
            ("lz_pass1_shard2d",
             [i32, i32, i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, vp, vp,
              vp, vp, vp, i32, i32, i32, i32, i32, i32, f32, vp]),
            ("lz_coop_max_blocks", []),
            ("lz_num_sms", []),
            ("lz_iter_fit", [i32, i32, i32, i32, i32]),
            ("lz_iter", [i32, i32, i32, i32, vp, vp, pp, i32, vp, vp, i32,
                         i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, f32,
                         vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    lib.lz_error_string.argtypes = [i32]
    lib.lz_error_string.restype = ctypes.c_char_p
    if lib.lz_max_cols() != MAX_M or lib.lz_max_specs() != MAX_SPECS:
        raise RuntimeError("csrc/lanczos2d.cu limits differ from MAX_M / "
                           "MAX_SPECS")
    _lib_cache.append(lib)
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err, what):
    if err != 0:
        msg = _lib().lz_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check_fields(fields, like, what):
    """Planar fields shaped as `like`: (P, ny, nx), or (B, P, ny, nx) for a
    batch of B lanes, P in (1, 2). Returns B (1 unbatched; the kernels
    check its range)."""
    if like.dim() not in (3, 4) or like.shape[-3] not in (1, 2):
        raise ValueError(f"{what}: planar fields are ([B,] 1|2, ny, nx), "
                         f"got {tuple(like.shape)}")
    for f in fields:
        if not isinstance(f, torch.Tensor) or f.dtype != torch.float32:
            raise TypeError(f"{what}: fields must be float32 tensors")
        if f.device != like.device:
            raise ValueError(f"{what}: fields on {f.device} and {like.device}")
        if f.shape != like.shape:
            raise ValueError(f"{what}: field shape {tuple(f.shape)} != "
                             f"{tuple(like.shape)}")
        if not f.is_contiguous():
            raise ValueError(f"{what}: fields must be contiguous")
    return like.shape[0] if like.dim() == 4 else 1


def _check_scalars(scal, shape, like, what):
    """Scalars of `shape` per lane, with like's leading lane axis."""
    shape = tuple(like.shape[:-3]) + tuple(shape)
    if (scal.dtype != torch.float32 or tuple(scal.shape) != shape
            or scal.device != like.device or not scal.is_contiguous()):
        raise ValueError(f"{what}: scalars must be a contiguous float32 "
                         f"{shape} tensor on {like.device}")


def _aniso_weights(desc, like, what):
    """The face weights (wx, wy), checked against the field `like`: (ny, nx),
    or (B, ny, nx) for a batch of B lanes."""
    ws = (desc["wx"], desc["wy"])
    shape = tuple(like.shape[:-3]) + tuple(like.shape[-2:])
    if (tuple(like.shape[-2:]) != (desc["ny"], desc["nx"])
            or not all(_weight_ok(w, desc) and w.device == like.device
                       and tuple(w.shape) == shape for w in ws)):
        raise ValueError(f"{what}: face weights must be contiguous float32 "
                         f"{shape} tensors on {like.device}")
    return ws


def _check_aux(t, shape, like, what, name):
    """A halo or weight array: contiguous float32 of `shape` on like's
    device."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.device != like.device or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{what}: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {like.device}")
    return t


def _bucket(n):
    """csrc's template bucket of a column count (lz_common.cuh bucket)."""
    return 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32


def _check_cols(n, what):
    if n + 1 > MAX_M:
        raise ValueError(f"{what}: at most {MAX_M} columns, got {n + 1}")


# ------------------------------------------------------------ plain versions

def _stencil_ref(u, desc):
    """5-point no-flux Laplacian of a planar ([B,] P, ny, nx) field:
    out-of-grid neighbours are 0, the variant diagonal comes from the
    indices."""
    ny, nx = u.shape[-2:]
    rows = torch.arange(ny, device=u.device)[:, None]
    cols = torch.arange(nx, device=u.device)[None, :]
    top, bot = rows == 0, rows == ny - 1
    lft, rgt = cols == 0, cols == nx - 1
    if desc["variant"] == "reference":
        diag = torch.where(top | bot | lft | rgt, -3.0, -4.0).to(u.dtype)
    else:
        diag = -(4.0 - top.to(u.dtype) - bot.to(u.dtype) - lft.to(u.dtype)
                 - rgt.to(u.dtype))
    zr = torch.zeros_like(u[..., :1, :])
    zc = torch.zeros_like(u[..., :, :1])
    above = torch.cat([zr, u[..., :-1, :]], dim=-2)
    below = torch.cat([u[..., 1:, :], zr], dim=-2)
    left = torch.cat([zc, u[..., :, :-1]], dim=-1)
    right = torch.cat([u[..., :, 1:], zc], dim=-1)
    return (above + below + left + right + diag * u) * (
        float(desc["scale"]) * float(desc["sign"]))


def _stencil_aniso_ref(u, desc):
    """div(c grad u) of a planar ([B,] P, ny, nx) field from the zero-padded
    face weights ((ny, nx), or (B, ny, nx) per lane), in the order of terms
    of the Pallas `_stencil_aniso`: fx - fx[x-1] + fy - fy[r-1], with
    fx = wx (u[x+1] - u) and fy = wy (u[r+1] - u); no face lies left of
    x = 0 or above r = 0."""
    wx, wy = desc["wx"].unsqueeze(-3), desc["wy"].unsqueeze(-3)
    zr = torch.zeros_like(u[..., :1, :])
    zc = torch.zeros_like(u[..., :, :1])
    fx = wx * (torch.cat([u[..., :, 1:], zc], dim=-1) - u)
    fx_l = torch.cat([zc, fx[..., :, :-1]], dim=-1)
    fy = wy * (torch.cat([u[..., 1:, :], zr], dim=-2) - u)
    fy_u = torch.cat([zr, fy[..., :-1, :]], dim=-2)
    return (fx - fx_l + fy - fy_u) * (
        float(desc["scale"]) * float(desc["sign"]))


def _lane(x):
    """A per-lane scalar ([B]) broadcast against ([B,] P, ny, nx) fields."""
    return x[..., None, None, None]


def _dots(a, b):
    """Hermitian product <a, b> = sum conj(a) b of planar ([B,] P, ny, nx)
    fields, ([B,] 2) as (re, im)."""
    def total(x):
        return torch.sum(x, dim=(-2, -1))
    a0, b0 = a[..., 0, :, :], b[..., 0, :, :]
    if a.shape[-3] == 1:
        re = total(a0 * b0)
        return torch.stack([re, torch.zeros_like(re)], dim=-1)
    a1, b1 = a[..., 1, :, :], b[..., 1, :, :]
    return torch.stack([total(a0 * b0 + a1 * b1),
                        total(a0 * b1 - a1 * b0)], dim=-1)


def _norm_ref(u):
    """||u||^2 of a planar ([B,] P, ny, nx) field, per lane."""
    return torch.sum(u * u, dim=(-3, -2, -1))


def _pass1_ref(scal, wj, prev, av, norm=False):
    w = _lane(scal[..., 0, 0]) * av
    if prev:
        w = w - _lane(scal[..., 0, 1]) * prev[-1]
    raw = torch.stack([_dots(wi, w) for wi in list(prev) + [wj]], dim=-2)
    return (w, raw, _norm_ref(wj)) if norm else (w, raw)


def pass1_iso2d_ref(scal, wj, prev, desc, norm=False):
    """Plain version of pass1_iso2d."""
    return _pass1_ref(scal, wj, prev, _stencil_ref(wj, desc), norm)


def pass1_aniso2d_ref(scal, wj, prev, desc, norm=False):
    """Plain version of pass1_aniso2d."""
    return _pass1_ref(scal, wj, prev, _stencil_aniso_ref(wj, desc), norm)


def _stencil_shard2d_ref(u, yh, xh, d):
    """The operator of a shard descriptor `d` on one shard's planar block
    ([B,] P, ny, nx), in the order of terms of the Pallas _stencil_shard2d /
    _stencil_shard2d_aniso. yh ([B,] P, 2, nx) holds the rows above and
    below the block, xh ([B,] P, 2, ny) the columns left and right of it
    (zeros at the domain's edge). Iso: the variant diagonal from global
    coordinates (y0, x0 offsets of (NY, NX)). Aniso: the padded face weights
    wx, wy ([B,] ny, nx), whose last column and row are the cross-shard
    faces, wxl ([B,] ny) the faces left of column 0 and wyh ([B,] nx) those
    above row 0. A batch carries the lane axis on every array but the
    offsets."""
    ny, nx = u.shape[-2:]
    above = torch.cat([yh[..., :1, :], u[..., :-1, :]], dim=-2)
    below = torch.cat([u[..., 1:, :], yh[..., 1:, :]], dim=-2)
    left = torch.cat([xh[..., 0, :, None], u[..., :, :-1]], dim=-1)
    right = torch.cat([u[..., :, 1:], xh[..., 1, :, None]], dim=-1)
    ss = float(d["scale"]) * float(d["sign"])
    if d["kind"] == "shard2d":
        diag = boundary_diagonal(
            block_coords((d["y0"], d["x0"]), (ny, nx), u.device),
            (d["NY"], d["NX"]), d["variant"], u.dtype)
        return (above + below + left + right + diag * u) * ss
    wx, wy = d["wx"].unsqueeze(-3), d["wy"]
    fx = wx * (right - u)
    fx_l = torch.cat([d["wxl"][..., None, :, None]
                      * (u[..., :, :1] - left[..., :, :1]),
                      fx[..., :, :-1]], dim=-1)
    fy = wy.unsqueeze(-3) * (below - u)
    wy_up = torch.cat([d["wyh"][..., None, :], wy[..., :-1, :]], dim=-2)
    fy_m1 = wy_up.unsqueeze(-3) * (u - above)
    return (fx - fx_l + fy - fy_m1) * ss


def pass1_shard2d_ref(scal, wj, prev, yh, xh, d):
    """Plain version of pass1_shard2d."""
    return _pass1_ref(scal, wj, prev, _stencil_shard2d_ref(wj, yh, xh, d))


def _rebuild_ref(scal, av, W):
    def sc(i, c):                    # lane scalars against (ny, nx) planes
        return scal[..., i, c, None, None]
    s = sc(0, 0)
    a0 = s * av[..., 0, :, :]
    a1 = s * av[..., 1, :, :] if av.shape[-3] == 2 else None
    for i, wi in enumerate(W):
        cr = sc(1 + i, 0)
        w0 = wi[..., 0, :, :]
        if a1 is None:
            a0 = a0 - cr * w0
        else:
            ci, w1 = sc(1 + i, 1), wi[..., 1, :, :]
            a0 = a0 - (cr * w0 - ci * w1)
            a1 = a1 - (cr * w1 + ci * w0)
    return (a0.unsqueeze(-3) if a1 is None
            else torch.stack([a0, a1], dim=-3))


def _pipe_ref(scal, av, W, last, stencil):
    wn = _rebuild_ref(scal, av, W)
    nsq = _norm_ref(wn)[..., None, None]
    gram = torch.stack([_dots(wi, wn) for wi in W], dim=-2)
    if last:
        return wn, nsq, gram
    avn = stencil(wn)
    d = torch.stack([_dots(wi, avn) for wi in W] + [_dots(wn, avn)], dim=-2)
    return wn, avn, nsq, gram, d


def pipe_iso2d_ref(scal, av, W, desc, last):
    """Plain version of pipe_iso2d."""
    return _pipe_ref(scal, av, W, last, lambda u: _stencil_ref(u, desc))


def pipe_aniso2d_ref(scal, av, W, desc, last):
    """Plain version of pipe_aniso2d."""
    return _pipe_ref(scal, av, W, last,
                     lambda u: _stencil_aniso_ref(u, desc))


def _operator_ref(u, desc):
    """The operator of any descriptor kind on a planar field."""
    if desc["kind"] == "laplacian_2d":
        return _stencil_ref(u, desc)
    if desc["kind"] == "aniso_laplacian_2d":
        return _stencil_aniso_ref(u, desc)
    from nlsolvers_tpu_torch.ops.cuda.lanczos3d import _stencil3d_ref
    return _stencil3d_ref(u, desc)


def iter_ref(scal, wj, prev, desc):
    """Plain version of iter_step: pass1, then pass2 with q_i = s_i^2 raw_i,
    in the order of operations of the Pallas _iter_call; on a batch
    vectorised over the lanes."""
    from nlsolvers_tpu_torch.ops.cuda.lanczos3d import pass2_ref
    w, raw = _pass1_ref(scal[..., :2], wj, prev, _operator_ref(wj, desc))
    sv = scal[..., 0, 2:]
    wn, nsq = pass2_ref((sv * sv)[..., :, None] * raw, w, list(prev) + [wj])
    return wn, raw, nsq


def combine_ref(q, W):
    """Plain version of combine."""
    def pl(i, p):
        return W[i][..., p, :, :]

    outs = []
    for spec in range(q.shape[-3]):
        def qs(i, c):
            return q[..., spec, i, c, None, None]
        if W[0].shape[-3] == 1:
            acc = qs(0, 0) * pl(0, 0)
            for i in range(1, len(W)):
                acc = acc + qs(i, 0) * pl(i, 0)
            outs.append(acc.unsqueeze(-3))
            continue
        a, b = qs(0, 0), qs(0, 1)
        y0 = a * pl(0, 0) - b * pl(0, 1)
        y1 = a * pl(0, 1) + b * pl(0, 0)
        for i in range(1, len(W)):
            a, b = qs(i, 0), qs(i, 1)
            y0 = y0 + a * pl(i, 0) - b * pl(i, 1)
            y1 = y1 + a * pl(i, 1) + b * pl(i, 0)
        outs.append(torch.stack([y0, y1], dim=-3))
    return tuple(outs)


# ------------------------------------------------------------ kernel wrappers

def _pass1(scal, wj, prev, desc, aniso, norm, what):
    """Checks, then launches K1 (iso) or K1' (aniso) on CUDA fields."""
    B = _check_fields([wj, *prev], wj, what)
    _check_scalars(scal, (1, 2), wj, what)
    lib = _lib()
    j = len(prev)
    P, ny, nx = wj.shape[-3:]
    lead = tuple(wj.shape[:-3])
    ss = float(desc["scale"]) * float(desc["sign"])
    w = torch.empty_like(wj)
    nout = 2 * j + 3                       # raw (re, im), i <= j; ||W_j||^2
    partial = torch.empty(lib.lz_pass1_blocks() * B * nout,
                          dtype=torch.float32, device=wj.device)
    red = torch.empty(lead + (nout,), dtype=torch.float32, device=wj.device)
    head = (B, P, scal.data_ptr(), wj.data_ptr(), _ptrs(prev), j)
    outs = (w.data_ptr(), partial.data_ptr(), red.data_ptr(), ny, nx, ss)
    if aniso:
        wx, wy = _aniso_weights(desc, wj, what)
        err = lib.lz_pass1_aniso2d(*head, wx.data_ptr(), wy.data_ptr(),
                                   *outs, _stream(wj))
    else:
        err = lib.lz_pass1_iso2d(*head, *outs,
                                 int(desc["variant"] == "clean"),
                                 _stream(wj))
    _check(err, what)
    raw = red[..., :nout - 1].view(lead + (j + 1, 2))
    return (w, raw, red[..., nout - 1]) if norm else (w, raw)


def pass1_iso2d(scal, wj, prev, desc, norm=False):
    """K1: w = s_j A(W_j) - bs W_{j-1} and raw (j+1, 2) = <W_i, w>, i <= j.

    scal: (1, 2) float32 [s_j, bs] on the fields' device; wj: W_j;
    prev: W_0..W_{j-1} (j = len(prev) >= 0). Returns (w, raw), with `norm`
    (w, raw, ||W_j||^2) (a 0-d tensor), from the same pass. A batch of B
    lanes: fields (B, P, ny, nx), scal (B, 1, 2), raw (B, j+1, 2), the norm
    (B,), in one launch.
    """
    _check_cols(len(prev), "pass1_iso2d")
    if not use_kernel(wj):
        return pass1_iso2d_ref(scal, wj, prev, desc, norm)
    out = _pass1(scal, wj, prev, desc, False, norm, "pass1_iso2d")
    pass1_iso2d.launches += 1
    return out


pass1_iso2d.launches = 0


def pass1_aniso2d(scal, wj, prev, desc, norm=False):
    """K1': pass1_iso2d for the div(c grad u) operator of an
    "aniso_laplacian_2d" descriptor (face weights wx, wy on the field's
    device: (ny, nx), or (B, ny, nx) for a batch's lanes)."""
    _check_cols(len(prev), "pass1_aniso2d")
    if not use_kernel(wj):
        return pass1_aniso2d_ref(scal, wj, prev, desc, norm)
    out = _pass1(scal, wj, prev, desc, True, norm, "pass1_aniso2d")
    pass1_aniso2d.launches += 1
    return out


pass1_aniso2d.launches = 0


def pass1_shard2d(scal, wj, prev, yh, xh, d):
    """K1' in modes shard2d and shard2d_aniso: pass1_iso2d on one shard's
    (P, ny, nx) block of a sharded 2D grid.

    yh (P, 2, nx): the rows above row 0 and below row ny-1; xh (P, 2, ny):
    the columns left of column 0 and right of column nx-1 (the neighbours'
    edges, zeros at the domain's edge). `d` describes the shard's operator:
    kind "shard2d" (variant, offsets y0, x0 and the global NY, NX for the
    diagonal) or "shard2d_aniso" (face weights wx, wy (ny, nx), wxl (ny),
    wyh (nx)), scale and sign. Returns (w, raw) as pass1_iso2d. A batch of
    B lanes of the block: fields (B, P, ny, nx), scal (B, 1, 2), halos and
    face weights with a leading B, raw (B, j+1, 2), in one launch whose
    lane b gives the bits of the launch on lane b alone.
    """
    what = "pass1_shard2d"
    _check_cols(len(prev), what)
    if not use_kernel(wj):
        return pass1_shard2d_ref(scal, wj, prev, yh, xh, d)
    B = _check_fields([wj, *prev], wj, what)
    _check_scalars(scal, (1, 2), wj, what)
    P, ny, nx = wj.shape[-3:]
    lead = tuple(wj.shape[:-3])
    if ny < 2 or nx < 2:
        raise ValueError(f"{what}: blocks need sides >= 2, got {(ny, nx)}")
    _check_aux(yh, lead + (P, 2, nx), wj, what, "yh")
    _check_aux(xh, lead + (P, 2, ny), wj, what, "xh")
    aniso = d["kind"] == "shard2d_aniso"
    if aniso:
        wts = [_check_aux(d[k], lead + shp, wj, what, k).data_ptr()
               for k, shp in (("wx", (ny, nx)), ("wy", (ny, nx)),
                              ("wxl", (ny,)), ("wyh", (nx,)))]
    else:
        wts = [None] * 4
    lib = _lib()
    j = len(prev)
    w = torch.empty_like(wj)
    partial = torch.empty(lib.lz_num_blocks(ny, nx) * B * 2 * (j + 1),
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty(lead + (j + 1, 2), dtype=torch.float32,
                      device=wj.device)
    _check(lib.lz_pass1_shard2d(
        B, P, int(aniso), int(d.get("variant") == "clean"), scal.data_ptr(),
        wj.data_ptr(), _ptrs(prev), j, *wts, yh.data_ptr(), xh.data_ptr(),
        w.data_ptr(), partial.data_ptr(), raw.data_ptr(), ny, nx,
        int(d.get("y0", 0)), int(d.get("x0", 0)), int(d.get("NY", 0)),
        int(d.get("NX", 0)), float(d["scale"]) * float(d["sign"]),
        _stream(wj)), what)
    pass1_shard2d.launches += 1
    return w, raw


pass1_shard2d.launches = 0


def _pipe(scal, av, W, desc, last, aniso, what):
    """Checks, then launches K2 (iso) or K2' (aniso) on CUDA fields."""
    nw = len(W)
    B = _check_fields([av, *W], av, what)
    _check_scalars(scal, (nw + 1, 2), av, what)
    lib = _lib()
    P, ny, nx = av.shape[-3:]
    lead = tuple(av.shape[:-3])
    ss = float(desc["scale"]) * float(desc["sign"])
    nout = 1 + 2 * nw + (0 if last else 2 * (nw + 1))
    wn = torch.empty_like(av)
    avn = None if last else torch.empty_like(av)
    partial = torch.empty(lib.lz_pipe_blocks() * B * nout,
                          dtype=torch.float32, device=av.device)
    red = torch.empty(lead + (nout,), dtype=torch.float32, device=av.device)
    head = (B, P, int(last), scal.data_ptr(), av.data_ptr(), _ptrs(W), nw)
    outs = (wn.data_ptr(), None if last else avn.data_ptr(),
            partial.data_ptr(), red.data_ptr(), ny, nx, ss)
    if aniso:
        wx, wy = _aniso_weights(desc, av, what)
        err = lib.lz_pipe_aniso2d(*head, wx.data_ptr(), wy.data_ptr(), *outs,
                                  _stream(av))
    else:
        err = lib.lz_pipe_iso2d(*head, *outs,
                                int(desc["variant"] == "clean"), _stream(av))
    _check(err, what)
    nsq = red[..., :1].view(lead + (1, 1))
    gram = red[..., 1:1 + 2 * nw].view(lead + (nw, 2))
    if last:
        return wn, nsq, gram
    return (wn, avn, nsq, gram,
            red[..., 1 + 2 * nw:].view(lead + (nw + 1, 2)))


def pipe_iso2d(scal, av, W, desc, last):
    """K2: one pipelined Lanczos iteration j = len(W) - 1.

    scal: (j+2, 2) float32 [(s_j, 0), c_0..c_j] (complex c_i); av: av_j;
    W: W_0..W_j. Returns (W_{j+1}, av_{j+1}, nsq (1,1), gram (j+1,2),
    d (j+2,2)), or (W_{j+1}, nsq, gram) when `last`. A batch of B lanes:
    fields (B, P, ny, nx), every scalar array with a leading B, in one
    launch.
    """
    _check_cols(len(W), "pipe_iso2d")
    if not use_kernel(av):
        return pipe_iso2d_ref(scal, av, W, desc, last)
    out = _pipe(scal, av, W, desc, last, False, "pipe_iso2d")
    pipe_iso2d.launches += 1
    return out


pipe_iso2d.launches = 0


def pipe_aniso2d(scal, av, W, desc, last):
    """K2': pipe_iso2d for the div(c grad u) operator of an
    "aniso_laplacian_2d" descriptor (face weights (ny, nx), or (B, ny, nx)
    for a batch's lanes). The `last` iteration computes no stencil and
    reads no weights."""
    _check_cols(len(W), "pipe_aniso2d")
    if not use_kernel(av):
        return pipe_aniso2d_ref(scal, av, W, desc, last)
    out = _pipe(scal, av, W, desc, last, True, "pipe_aniso2d")
    pipe_aniso2d.launches += 1
    return out


pipe_aniso2d.launches = 0


def combine(q, W):
    """K3: y_spec = sum_i q[spec, i] W_i (complex q, s_i folded in) for the
    k = q.shape[-3] specs in one pass over the m = len(W) columns. A batch
    of B lanes: columns (B, P, ny, nx) and q (B, k, m, 2), in one launch."""
    k, m = q.shape[-3], len(W)
    if m > MAX_M or k > MAX_SPECS:
        raise ValueError(f"combine: at most {MAX_M} columns and {MAX_SPECS} "
                         f"specs, got {m} and {k}")
    if not use_kernel(W[0]):
        return combine_ref(q, W)
    B = _check_fields(W, W[0], "combine")
    _check_scalars(q, (k, m, 2), W[0], "combine")
    P, ny, nx = W[0].shape[-3:]
    outs = [torch.empty_like(W[0]) for _ in range(k)]
    _check(_lib().lz_combine(B, P, q.data_ptr(), _ptrs(W), m, k, _ptrs(outs),
                             ny, nx, _stream(W[0])), "combine")
    combine.launches += 1
    return tuple(outs)


combine.launches = 0


def _iter_opk(desc, what):
    """csrc/lanczos2d.cu's operator code of K5 for `desc`; the operators of
    the Pallas _iter_call only (iso2d, aniso2d, iso3d)."""
    kind = desc["kind"]
    if kind == "laplacian_2d":
        return 0
    if kind == "aniso_laplacian_2d":
        return 1
    if kind == "laplacian_3d":
        return 2 if desc["variant"] == "reference" else 3
    raise ValueError(f"{what}: the fused iteration takes the 2D operators "
                     f"and the 3D Laplacian (the modes of the Pallas "
                     f"_iter_call), not {kind}")


def iter_plan(P, rows, nx, sms, fit, B=1):
    """(onchip, grid) of a K5 launch on a (P, rows, nx) field, or on each
    of a batch of B such lanes.

    K5's blocks split the S = ceil(nx / 128) * rows rows of 128-column
    strips evenly, ceil(S / grid) each. The on-chip form keeps each block's
    w rows in shared memory: it takes the largest grid of COOP_PER_SM, then
    fewer, blocks per SM (at most S blocks) whose blocks all fit on the card
    at once with those rows. A field whose w fits no such grid takes the
    global form (w in a device scratch) on the most blocks that fit, at most
    COOP_PER_SM per SM. `fit(dyn)`: the blocks per SM that fit with dyn
    bytes of dynamic shared memory; sms: the card's SMs. This is a rule of
    size: a launch takes the form it gives, or raises.

    A batch keeps one lane's grid, so that each block walks the same
    segments of every lane and each lane reduces its sums in the order of
    its launch alone (its bits). It keeps w on chip where the blocks of
    that grid hold the rows of all B lanes, else takes the global form,
    which gives the same bits.
    """
    segs = -(-nx // STRIP_COLS) * rows
    for per_sm in range(COOP_PER_SM, 0, -1):
        grid = min(per_sm * sms, segs)
        if fit(-(-segs // grid) * P * STRIP_COLS * 4) * sms >= grid:
            break
    else:
        per_sm = min(COOP_PER_SM, fit(ITER_WARPS * P * STRIP_COLS * 4))
        if per_sm < 1:
            raise RuntimeError("iter_step: no block of the kernel fits on "
                               "the card")
        return False, min(per_sm * sms, segs)
    if B == 1 or fit(B * -(-segs // grid) * P * STRIP_COLS * 4) * sms >= grid:
        return True, grid
    if fit(ITER_WARPS * P * STRIP_COLS * 4) * sms < grid:
        raise RuntimeError(f"iter_step: {grid} blocks of the global form do "
                           f"not fit on the card")
    return False, grid


_plan_cache = {}


def iter_form(P, rows, nx, opk, j, vec, B=1):
    """iter_plan for the K5 instantiation of a call (P, the operator code
    opk, iteration j, the 16-byte form vec, B lanes), the card's numbers
    read from the library once per instantiation and shape."""
    key = (P, rows, nx, opk, _bucket(j), bool(vec), B)
    if key not in _plan_cache:
        lib = _lib()
        _plan_cache[key] = iter_plan(
            P, rows, nx, lib.lz_num_sms(),
            lambda dyn: lib.lz_iter_fit(P, opk, j, int(vec), dyn), B)
    return _plan_cache[key]


def iter_step(scal, wj, prev, desc):
    """K5: one whole Lanczos iteration j = len(prev) in one launch.

    scal: (1, j+3) float32 [s_j, bs, s_0..s_j] on the fields' device; wj:
    W_j; prev: W_0..W_{j-1}, planar (P, rows, nx) fields (the merged view
    for the 3D Laplacian). Returns (W_{j+1}, raw (j+1, 2), nsq (1, 1)):
    w = s_j A(W_j) - bs W_{j-1}, raw_i = <W_i, w>, W_{j+1} = w - sum_i
    s_i^2 raw_i W_i and ||W_{j+1}||^2. w stays in shared memory where
    iter_plan finds room for it, else in a scratch field. A batch of B
    lanes: fields (B, P, rows, nx), scal (B, 1, j+3), raw (B, j+1, 2), nsq
    (B, 1, 1), aniso weights (B, ny, nx), in one launch whose lane b gives
    the bits of the launch on lane b alone.
    """
    j = len(prev)
    _check_cols(j, "iter_step")
    opk = _iter_opk(desc, "iter_step")
    if not use_kernel(wj):
        return iter_ref(scal, wj, prev, desc)
    B = _check_fields([wj, *prev], wj, "iter_step")
    _check_scalars(scal, (1, j + 3), wj, "iter_step")
    P, rows, nx = wj.shape[-3:]
    lead = tuple(wj.shape[:-3])
    wx = wy = None
    if opk >= 2:
        nz, ny = desc["nz"], desc["ny"]
        if (rows, nx) != (nz * ny, desc["nx"]):
            raise ValueError(f"iter_step: field {tuple(wj.shape)} is not the "
                             f"merged view of a ({nz}, {ny}, {desc['nx']}) "
                             f"grid")
    else:
        nz, ny = 1, rows
        if (rows, nx) != (desc["ny"], desc["nx"]):
            raise ValueError(f"iter_step: field {tuple(wj.shape)} on a "
                             f"({desc['ny']}, {desc['nx']}) operator")
        if opk == 1:
            wx, wy = _aniso_weights(desc, wj, "iter_step")
    lib = _lib()
    wn = torch.empty_like(wj)
    vec = nx % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in [wj, wn, *prev] + [
            x for x in (wx, wy) if x is not None])
    onchip, grid = iter_form(P, rows, nx, opk, j, vec, B)
    w = None if onchip else torch.empty_like(wj)
    partial = torch.empty(B * (2 * MAX_M + 1) * lib.lz_coop_max_blocks(),
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty(lead + (j + 1, 2), dtype=torch.float32,
                      device=wj.device)
    nsq = torch.empty(lead + (1, 1), dtype=torch.float32, device=wj.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    _check(lib.lz_iter(B, P, opk, int(vec), scal.data_ptr(), wj.data_ptr(),
                       _ptrs(prev), j, ptr(wx), ptr(wy),
                       int(desc["variant"] == "clean"), int(onchip), grid,
                       ptr(w), wn.data_ptr(), partial.data_ptr(),
                       raw.data_ptr(), nsq.data_ptr(), nz, ny, nx,
                       float(desc["scale"]) * float(desc["sign"]),
                       _stream(wj)), "iter_step")
    iter_step.launches += 1
    return wn, raw, nsq


iter_step.launches = 0


# ------------------------------------------------------------ Lanczos driver

def safe_inv(nrm):
    """1/nrm, and 0 for a zero norm: a zero column (zero start vector or
    exact breakdown) then contributes nothing and the result stays finite."""
    pos = nrm > 0
    return torch.where(pos, 1.0 / torch.where(pos, nrm, torch.ones_like(nrm)),
                       torch.zeros_like(nrm))


def _pipe_kernels(desc):
    """(pass1, pipe) of the pipelined loop for `desc`: K1/K2, K1'/K2', or
    in 3D pass1_3d and K8 pipe_3d, whose last, stencil-free iteration is
    K2's geometry-free LAST launch on the merged view. pass1 returns
    (av, d, ||u||^2): K1 and K1' take the norm in the same pass; in 3D it
    is pass2's norm-only form, one launch more, so that a lane's norm has
    the same bits in a batch and alone."""
    kind = desc["kind"]
    if kind == "aniso_laplacian_2d":
        return functools.partial(pass1_aniso2d, norm=True), pipe_aniso2d
    if kind in KINDS_3D:
        from nlsolvers_tpu_torch.ops.cuda import lanczos3d

        def pass1(scal, u, prev, desc):
            nsq = lanczos3d.pass2(None, u, [])[1][..., 0, 0]
            return lanczos3d.pass1_3d(scal, u, prev, desc) + (nsq,)

        def pipe(scal, av, W, desc, last):
            if last:
                return pipe_iso2d(scal, av, W, desc, True)
            return lanczos3d.pipe_3d(scal, av, W, desc)

        return pass1, pipe
    return functools.partial(pass1_iso2d, norm=True), pipe_iso2d


def _lanczos_pipe(u, m, desc):
    """Pipelined single-pass Lanczos: pass1 once, then the pipe m-1 times
    (kernels from _pipe_kernels; the 3D one is the JAX package's
    lanczos3d_pipe.lanczos_pipe3d, with the same scalar recurrence).
    `u` is one planar field (P, R, nx), or a batch (B, P, R, nx) whose
    lanes run through the same launches: every scalar below then carries a
    leading B (the per-lane arithmetic is the same elementwise ops).

    w_j = s_j av_j - bs W_{j-1} (bs = beta_{j-1} s_{j-1}) is never
    materialized: its projections raw_i = <W_i, w_j> are recovered as
    s_j d_i - bs <W_i, W_{j-1}>, with d_i = <W_i, av_j> from the previous
    kernel and the gram terms <W_i, W_{j-1}> from the kernel before that
    (i = j-1: beta_{j-2}^2; i = j: conj of the previous gram's last entry).
    The rebuild coefficients fold the recurrence term in:
    c_i = s_i^2 raw_i + (i == j-1) bs.
    """
    pass1, pipe = _pipe_kernels(desc)
    lead = tuple(u.shape[:-3])
    f32 = dict(dtype=torch.float32, device=u.device)
    zero = torch.zeros(lead, **f32)

    def pair(re, im):                # ([B,] 1, 2) rows of (re, im)
        return torch.stack([re, im], dim=-1)[..., None, :]

    def per_lane(x):                 # [B] scalars against ([B,] k, 2)
        return x[..., None, None]

    # init: av_0 = A(W_0), d_0 = <W_0, av_0> and ||W_0||^2, i.e. pass1
    # with [1, 0]
    av, d_prev, nsq0 = pass1(
        torch.eye(1, 2, **f32).expand(lead + (1, 2)).contiguous(), u, [],
        desc)
    beta0 = torch.sqrt(nsq0)
    W, s = [u], [safe_inv(beta0)]
    alphas, betas = [], []
    g_prev = g_prev2 = None
    for j in range(m - 1):
        sj = s[j]
        if j == 0:
            raw = per_lane(sj) * d_prev
            bs = zero
        else:
            bs = betas[j - 1] * s[j - 1]
            parts = [] if j < 2 else [g_prev2]               # i <= j-2
            nb2 = betas[j - 2] ** 2 if j >= 2 else nsq0      # i = j-1
            parts.append(pair(nb2, zero))
            parts.append(pair(g_prev[..., j - 1, 0],         # i = j (conj)
                              -g_prev[..., j - 1, 1]))
            raw = (per_lane(sj) * d_prev
                   - per_lane(bs) * torch.cat(parts, dim=-2))
        sv = torch.stack(s, dim=-1)                          # ([B,] j+1)
        proj = sv[..., :, None] * raw
        alphas.append(proj[..., j, 0])
        c = sv[..., :, None] * proj
        if j > 0:
            c[..., j - 1, 0] += bs
        scal = torch.cat([pair(sj, zero), c], dim=-2)
        last = j == m - 2
        res = pipe(scal, av, W, desc, last)
        if last:
            wn, nsq, gram = res
        else:
            wn, av, nsq, gram, d_prev = res
        b = torch.sqrt(nsq[..., 0, 0])
        W.append(wn)
        betas.append(b)
        s.append(safe_inv(b))
        g_prev2, g_prev = g_prev, gram
    return W, s, alphas, betas, beta0


def lanczos_planar(u, desc, m):
    """Fused-kernel Lanczos on a planar (P, ny, nx) float32 field, or for
    the 3D kinds on the merged (P, nz*ny, nx) view of an (nz, ny, nx) grid.

    Returns (W, s, alpha, beta, beta0): unnormalized Krylov columns W (list;
    W[i] * s[i] is the normalized v_i), their inverse norms s, and the
    entries of T, with the semantics of ops/krylov.lanczos. 2D runs the
    pipelined K1/K2 loop, 3D the two-pass loop of ops/cuda/lanczos3d.py or,
    with config.pipeline_3d, the pipelined loop with K8. With
    config.fused_iter a field of at most FUSED_ITER_BYTES runs the two-pass
    loop with one K5 per iteration instead (the 3D c(x) operator raises a
    ValueError there, as the JAX package's _iter_call has no mode for it).

    A batch (B, P, ny, nx) or (B, P, nz*ny, nx) runs the loop one lane
    would take over every lane at once, one launch of each kernel (K5 and
    K8 too) for all lanes: each column is a (B, ...) tensor, each scalar
    (B,). The FUSED_ITER_BYTES gate is per lane, as JAX's is under vmap.
    """
    three_d = desc is not None and desc.get("kind") in KINDS_3D
    grid = tuple(u.shape[-2:])
    if three_d and grid == (desc.get("nz", 0) * desc.get("ny", 0),
                            desc.get("nx")):
        grid = (desc["nz"], desc["ny"], desc["nx"])      # the merged view
    if not supported_desc(desc, grid, torch.float32):
        raise NotImplementedError(
            f"fused Lanczos takes the 2D and 3D stencil descriptors "
            f"({KINDS_2D + KINDS_3D}), got a "
            f"{None if desc is None else desc.get('kind')} descriptor for a "
            f"{tuple(u.shape)} field")
    if m > MAX_M:
        raise ValueError(f"Krylov m={m} exceeds the kernels' {MAX_M}")
    if m > 1:
        from nlsolvers_tpu_torch.ops.cuda import lanczos3d
        lane_bytes = u.shape[-3] * u.shape[-2] * u.shape[-1] * 4
        if config.fused_iter and lane_bytes <= FUSED_ITER_BYTES:
            _iter_opk(desc, "fused_iter")
            return lanczos3d.lanczos_twopass(u, desc, m, fused=True)
        if three_d and not config.pipeline_3d:
            return lanczos3d.lanczos_twopass(u, desc, m)
        return _lanczos_pipe(u, m, desc)
    beta0 = torch.sqrt(torch.sum(u * u, dim=(-3, -2, -1)))
    return [u], [safe_inv(beta0)], [], [], beta0


def matfunc_apply_planar(u, desc, t, func, m):
    """y = f(t * sign*scale*L) u on a planar (P, ny, nx) float32 field (the
    merged (P, nz*ny, nx) view for the 3D kinds), or on each lane of a
    batch (B, P, ny, nx) or (B, P, nz*ny, nx)."""
    return matfunc_apply_planar_multi(u, desc, ((t, func),), m)[0]


def matfunc_apply_planar_multi(u, desc, specs, m):
    """[f(t L) u for (t, f) in specs] from ONE fused-kernel Lanczos run and
    one combine pass. Serves the 2D and the 3D kinds: combine is
    geometry-free."""
    W, s, alphas, betas, beta0 = lanczos_planar(u, desc, m)
    return combine(combine_coefficients(s, alphas, betas, beta0, specs, m), W)


def combine_coefficients(s, alphas, betas, beta0, specs, m):
    """The (len(specs), m, 2) float32 q of K3 combine for the Lanczos run
    (s, alphas, betas, beta0): q[spec, i] = (Re coef_i s_i, Im coef_i s_i)
    with coef = f(t T) e1 beta0 for each (t, f) in specs. For a batch the
    scalars carry a leading B and q is (B, len(specs), m, 2), from one
    batched eigh."""
    alpha, beta = krylov.tridiag_entries(alphas, betas, beta0, m,
                                         torch.float32)
    lam, Q = krylov.tridiag_eigh(alpha, beta)
    sv = torch.stack(s, dim=-1)
    rows = []
    for t, func in specs:
        coef = krylov.coefficients(func, t, lam, Q, beta0)
        if coef.is_complex():
            cr, ci = coef.real, coef.imag
        else:
            cr, ci = coef, torch.zeros_like(coef)
        rows.append(torch.stack([cr.to(torch.float32) * sv,
                                 ci.to(torch.float32) * sv], dim=-1))
    return torch.stack(rows, dim=-3)
