"""Fused Lanczos for the 3D no-flux operators (iso3d, aniso3d).

Port of nlsolvers_tpu/ops/pallas/lanczos3d_pipe.py (`lanczos_twopass3d_y`,
`lanczos_pipe3d`) and of the 3D parts of lanczos2d.lanczos_planar. State is
PLANAR float32 on the merged row view: a complex (nz, ny, nx) field is
(2, R, nx) with R = nz * ny, a real one (1, R, nx). Krylov columns W_i stay
UNNORMALIZED with their inverse norms s_i tracked as scalars, as in the 2D
loop.

Three hand-written CUDA kernels (csrc/lanczos3d.cu) carry the 3D loops;
each has its plain PyTorch version beside it and a launch counter on its
wrapper:

  pass1_3d / pass1_3d_ref   replaces lanczos3d_pipe._pass1y_call and
                            _pass1zy_call, and lanczos2d._pass1_call in
                            modes iso3d/aniso3d
  pass2    / pass2_ref      replaces lanczos2d._pass2_call
  pipe_3d  / pipe_3d_ref    replaces lanczos3d_pipe._pipe3d_call: the
                            opt-in single-pass pipe (config.pipeline_3d)
  pass1_shard3d / pass1_shard3d_ref
                            replaces lanczos3d_pipe._pass1y_shard_call (K9),
                            _pass1y_shard_aniso_call (K10), _pass1zy_shard_call
                            (K11), _pass1zy_shard_aniso_call (K12) and
                            lanczos2d._pass1_call in modes shard3d and
                            shard3d_aniso: pass1 on one shard's block of a
                            sharded 3D grid, a kernel of its own that marches
                            z through bricks of the block (shard3d_tiles)

`lanczos_twopass` is the normalized two-pass loop (pass1_3d then pass2), or
with fused=True one lanczos2d.iter_step (K5) per iteration, in 2D and 3D.

pass1_3d, pass2, pipe_3d, bc3d and pass1_shard3d also take a batch: fields
(B, P, R, nx) with a leading lane axis, scalars (B, ...) and, for the aniso
operator, face weights (B, R, nx) (operators.batched_aniso_laplacian_3d; a
shard's halos and edge weights with a leading B too), the form that
jax.vmap gives the Pallas kernels in the JAX package's datagen engine. A
batch is ONE launch, and lane b of it gives the bits of the unbatched
launch on lane b (csrc/lanczos3d.cu); the plain versions take the same
leading axis. The two-pass loop, the fused loop and the pipelined 3D loop
run a batch with their scalar recurrence on (B, ...) tensors; each loop's
start norm is pass2's norm-only form, so it too is the same for a lane in a
batch and alone. The pipelined 3D loop is lanczos2d._lanczos_pipe with
pipe_3d. The final
sum reuses lanczos2d's `combine` on the merged view, and the ghost copy
after the step is ops/cuda/bc3d.py. A wrapper launches its
kernel for a CUDA tensor under config.kernel_mode "auto" and raises if the
kernel cannot run; it takes the plain version for a CPU tensor, or under
"off". The kernels mask ragged edges, so the TPU's alignment gates (nx a
multiple of 128, ny of 8) do not apply: any grid with nz, ny, nx >= 3 runs.
"""

import ctypes

import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops.cuda import _build
from nlsolvers_tpu_torch.ops.cuda.lanczos2d import (KINDS_3D, MAX_M,
                                                    _bucket, _check_aux,
                                                    _check_fields,
                                                    _check_scalars,
                                                    _norm_ref, _pass1_ref,
                                                    _pipe_ref, _ptrs,
                                                    _stream, iter_step,
                                                    safe_inv)
from nlsolvers_tpu_torch.ops.operators import block_coords, boundary_diagonal

__all__ = ["supported_desc", "lanczos_twopass",
           "pass1_3d", "pass1_3d_ref", "pass2", "pass2_ref", "pipe_3d",
           "pipe_3d_ref", "pass1_shard3d", "pass1_shard3d_ref",
           "shard3d_tiles", "shard3d_scratch"]

# csrc/lanczos3d.cu's operator modes
_MODES = {"reference": 0, "clean": 1, "aniso": 2}


def supported_desc(desc, u_shape, dtype):
    """Can the 3D fused path run this operator/field combination? u_shape is
    the grid (nz, ny, nx)."""
    if desc is None or desc.get("kind") not in KINDS_3D:
        return False
    if desc["kind"] == "laplacian_3d":
        if desc.get("variant") not in ("reference", "clean"):
            return False
    elif any(desc.get(k) is None for k in ("wx", "wy", "wz")):
        return False
    grid = (desc.get("nz"), desc.get("ny"), desc.get("nx"))
    if tuple(u_shape) != grid:
        return False
    if dtype not in (torch.complex64, torch.float32):
        return False
    return min(grid) >= 3


# ------------------------------------------------------------ kernel plumbing

_lib_cache = []


def _lib():
    if _lib_cache:
        return _lib_cache[0]
    lib = _build.library("lanczos3d")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    pp = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
            ("lz3_pass1_blocks", [i32, i32, i32]),
            ("lz3_pass2_blocks", []),
            ("lz3_max_cols", []),
            ("lz3_pass1", [i32, i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, vp,
                           vp, i32, i32, i32, f32, vp]),
            ("lz3_pass2", [i32, i32, vp, vp, pp, i32, vp, vp, vp, i64, vp]),
            ("lz3_pass1_shard", [i32, i32, i32, i32, vp, vp, pp, i32]
             + [vp] * 12 + [i32] * 9 + [f32, i32, i32, i32, vp]),
            ("lz3_shard_blocks", [i32] * 6),
            ("lz3_shard_smem", [i32] * 5),
            ("lz3_bc3d", [i32, i32, vp] + [i32] * 9 + [vp]),
            ("lz3_pipe3d_rows", []),
            ("lz3_pipe3d_fit", [i32, i32, i32, i32]),
            ("lz3_pipe3d", [i32, i32, i32, i32, vp, vp, pp, i32, vp, vp, vp,
                            vp, vp, vp, vp, i32, i32, i32, f32, i32, i32,
                            vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    lib.lz3_error_string.argtypes = [i32]
    lib.lz3_error_string.restype = ctypes.c_char_p
    if lib.lz3_max_cols() != MAX_M:
        raise RuntimeError("csrc/lanczos3d.cu MAXCOLS differs from MAX_M")
    if lib.lz3_pipe3d_rows() != PIPE3D_ROWS:
        raise RuntimeError("csrc/lanczos3d.cu TY3 differs from PIPE3D_ROWS")
    _lib_cache.append(lib)
    return lib


def _check(err, what):
    if err != 0:
        msg = _lib().lz3_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _geom(desc, like, what):
    nz, ny, nx = desc["nz"], desc["ny"], desc["nx"]
    if tuple(like.shape[-2:]) != (nz * ny, nx):
        raise ValueError(f"{what}: field {tuple(like.shape)} is not the "
                         f"merged ([B,] P, {nz * ny}, {nx}) view of the "
                         f"operator's ({nz}, {ny}, {nx}) grid")
    return nz, ny, nx


def _weights(desc, like, what):
    """The face weights (wx, wy, wz), checked against the field `like`:
    (R, nx), or (B, R, nx) for a batch of B lanes."""
    ws = [desc[k] for k in ("wx", "wy", "wz")]
    shape = tuple(like.shape[:-3]) + tuple(like.shape[-2:])
    for w in ws:
        if (not isinstance(w, torch.Tensor) or w.dtype != torch.float32
                or w.device != like.device or not w.is_contiguous()
                or tuple(w.shape) != shape):
            raise ValueError(f"{what}: face weights must be contiguous "
                             f"float32 {shape} tensors on {like.device}")
    return ws


# ------------------------------------------------------------ plain versions

def _shift_rows(u, k):
    """v[..., r, :] = u[..., r - k, :] where 0 <= r - k < R, else 0 (k may
    be < 0)."""
    z = torch.zeros_like(u[..., :abs(k), :])
    if k > 0:
        return torch.cat([z, u[..., :-k, :]], dim=-2)
    return torch.cat([u[..., -k:, :], z], dim=-2)


def _shift_cols(u, k):
    """v[..., x] = u[..., x - k] where that column exists, else 0 (k = +-1)."""
    z = torch.zeros_like(u[..., :1])
    if k > 0:
        return torch.cat([z, u[..., :-1]], dim=-1)
    return torch.cat([u[..., 1:], z], dim=-1)


def _stencil3d_ref(u, desc):
    """The operator of `desc` on a planar ([B,] P, R, nx) field, merged
    view (aniso weights (R, nx), or (B, R, nx) per lane); the arithmetic
    order of lanczos3d_pipe._stencil_3d_y / _stencil_aniso_3d_y."""
    nz, ny, nx = desc["nz"], desc["ny"], desc["nx"]
    ss = float(desc["scale"]) * float(desc["sign"])
    if desc["kind"] == "aniso_laplacian_3d":
        wx, wy, wz = (desc[k].to(u.device).unsqueeze(-3)
                      for k in ("wx", "wy", "wz"))
        fx = wx * (_shift_cols(u, -1) - u)
        fx_l = _shift_cols(fx, 1)
        fy = wy * (_shift_rows(u, -1) - u)
        fy_m1 = _shift_rows(wy, 1) * (u - _shift_rows(u, 1))
        fz = wz * (_shift_rows(u, -ny) - u)
        fz_m = _shift_rows(wz, ny) * (u - _shift_rows(u, ny))
        return (fx - fx_l + fy - fy_m1 + fz - fz_m) * ss
    R = nz * ny
    rows = torch.arange(R, device=u.device)[:, None]
    zs, ys = rows // ny, rows % ny
    xs = torch.arange(nx, device=u.device)[None, :]
    bounds = [zs == 0, zs == nz - 1, ys == 0, ys == ny - 1, xs == 0,
              xs == nx - 1]
    above, below = _shift_rows(u, 1), _shift_rows(u, -1)
    if desc["variant"] == "reference":
        any_b = bounds[0]
        for b in bounds[1:]:
            any_b = any_b | b
        diag = torch.where(any_b, -5.0, -6.0).to(u.dtype)
    else:
        above = torch.where(bounds[2], 0.0, above)
        below = torch.where(bounds[3], 0.0, below)
        cnt = sum(b.to(u.dtype) for b in bounds)
        diag = -(6.0 - cnt)
    return (above + below + _shift_rows(u, ny) + _shift_rows(u, -ny)
            + _shift_cols(u, 1) + _shift_cols(u, -1) + diag * u) * ss


def pass1_3d_ref(scal, wj, prev, desc):
    """Plain version of pass1_3d."""
    return _pass1_ref(scal, wj, prev, _stencil3d_ref(wj, desc))


def _stencil_shard3d_ref(u, yh, zh, xh, d):
    """The operator of a 3D shard descriptor `d` on one shard's planar block,
    the merged ([B,] P, R = lnz*lny, nx) view, in the order of terms of the
    Pallas K9 (iso) and K10 (aniso) kernels. yh ([B,] P, 2, lnz, nx): the
    rows above y = 0 and below y = lny-1 of every local z-plane (the ay
    neighbours' edge rows, or under the reference variant, which keeps the
    z and y axes whole, the merged-view seam rows); zh ([B,] P, 2, lny, nx):
    the planes below z = 0 and above z = lnz-1; xh ([B,] P, 2, R): the
    columns left and right. Iso: the variant diagonal from global
    coordinates (offsets z0, y0, x0 of (NZ, NY, NX)). Aniso: the padded face
    weights wx, wy, wz ([B,] R, nx), wxl ([B,] R) left of column 0, wyh
    ([B,] lnz, nx) above each plane's row 0 and wzh ([B,] lny, nx) below
    plane 0. A batch carries the lane axis on every array but the
    offsets."""
    lead = tuple(u.shape[:-3])
    P, R, nx = u.shape[-3:]
    nz, ny = d["lnz"], d["lny"]
    u4 = u.view(lead + (P, nz, ny, nx))
    above = torch.cat([yh[..., 0, :, None, :], u4[..., :-1, :]], dim=-2)
    below = torch.cat([u4[..., 1:, :], yh[..., 1, :, None, :]], dim=-2)
    z_above = torch.cat([zh[..., :1, :, :], u4[..., :-1, :, :]], dim=-3)
    z_below = torch.cat([u4[..., 1:, :, :], zh[..., 1:, :, :]], dim=-3)
    above, below, z_above, z_below = (
        a.reshape(lead + (P, R, nx)) for a in (above, below, z_above,
                                               z_below))
    left = torch.cat([xh[..., 0, :, None], u[..., :, :-1]], dim=-1)
    right = torch.cat([u[..., :, 1:], xh[..., 1, :, None]], dim=-1)
    ss = float(d["scale"]) * float(d["sign"])
    if d["kind"] == "shard3d":
        coords = block_coords((d["z0"], d["y0"], d["x0"]), (nz, ny, nx),
                              u.device)
        diag = boundary_diagonal(coords, (d["NZ"], d["NY"], d["NX"]),
                                 d["variant"], u.dtype).reshape(R, nx)
        return (above + below + z_above + z_below + left + right
                + diag * u) * ss
    wx, wy, wz = d["wx"], d["wy"], d["wz"]
    fx = wx.unsqueeze(-3) * (right - u)
    fx_l = torch.cat([d["wxl"][..., None, :, None]
                      * (u[..., :, :1] - left[..., :, :1]),
                      fx[..., :, :-1]], dim=-1)
    fy = wy.unsqueeze(-3) * (below - u)
    wy_up = torch.cat([d["wyh"][..., :, None, :],
                       wy.view(lead + (nz, ny, nx))[..., :-1, :]],
                      dim=-2).reshape(lead + (R, nx))
    fy_m1 = wy_up.unsqueeze(-3) * (u - above)
    fz = wz.unsqueeze(-3) * (z_below - u)
    wz_up = torch.cat([d["wzh"][..., None, :, :],
                       wz.view(lead + (nz, ny, nx))[..., :-1, :, :]],
                      dim=-3).reshape(lead + (R, nx))
    fz_m = wz_up.unsqueeze(-3) * (u - z_above)
    return (fx - fx_l + fy - fy_m1 + fz - fz_m) * ss


def pass1_shard3d_ref(scal, wj, prev, yh, zh, xh, d):
    """Plain version of pass1_shard3d."""
    return _pass1_ref(scal, wj, prev, _stencil_shard3d_ref(wj, yh, zh, xh, d))


def pass2_ref(q, w, W):
    """Plain version of pass2."""
    if not W:
        return w, _norm_ref(w)[..., None, None]
    a0 = w[..., 0, :, :]
    a1 = w[..., 1, :, :] if w.shape[-3] == 2 else None
    for i, wi in enumerate(W):
        qr = q[..., i, 0, None, None]
        if a1 is None:
            a0 = a0 - qr * wi[..., 0, :, :]
        else:
            qi = q[..., i, 1, None, None]
            a0 = a0 - (qr * wi[..., 0, :, :] - qi * wi[..., 1, :, :])
            a1 = a1 - (qr * wi[..., 1, :, :] + qi * wi[..., 0, :, :])
    wn = a0.unsqueeze(-3) if a1 is None else torch.stack([a0, a1], dim=-3)
    return wn, _norm_ref(wn)[..., None, None]


def pipe_3d_ref(scal, av, W, desc):
    """Plain version of pipe_3d."""
    return _pipe_ref(scal, av, W, False, lambda u: _stencil3d_ref(u, desc))


# ------------------------------------------------------------ kernel wrappers

def _mode_weights(desc, like, what):
    """csrc/lanczos3d.cu's operator mode and the (wx, wy, wz) pointers."""
    aniso = desc["kind"] == "aniso_laplacian_3d"
    mode = _MODES["aniso" if aniso else desc["variant"]]
    ws = _weights(desc, like, what) if aniso else (None, None, None)
    return mode, [None if w is None else w.data_ptr() for w in ws]


def pass1_3d(scal, wj, prev, desc):
    """w = s_j A(W_j) - bs W_{j-1} and raw (j+1, 2) = <W_i, w>, i <= j, for
    the 3D operator of `desc` on the merged (P, R, nx) view.

    scal: (1, 2) float32 [s_j, bs] on the fields' device; wj: W_j;
    prev: W_0..W_{j-1} (j = len(prev) >= 0). Returns (w, raw). A batch of B
    lanes: fields (B, P, R, nx), scal (B, 1, 2), raw (B, j+1, 2), aniso
    weights (B, R, nx) (operators.batched_aniso_laplacian_3d), in one
    launch.
    """
    j = len(prev)
    if j + 1 > MAX_M:
        raise ValueError(f"pass1_3d: at most {MAX_M} columns, got {j + 1}")
    if not use_kernel(wj):
        return pass1_3d_ref(scal, wj, prev, desc)
    B = _check_fields([wj, *prev], wj, "pass1_3d")
    _check_scalars(scal, (1, 2), wj, "pass1_3d")
    nz, ny, nx = _geom(desc, wj, "pass1_3d")
    mode, wts = _mode_weights(desc, wj, "pass1_3d")
    lib = _lib()
    nout = 2 * (j + 1)
    w = torch.empty_like(wj)
    partial = torch.empty(lib.lz3_pass1_blocks(nz, ny, nx) * B * nout,
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty(tuple(wj.shape[:-3]) + (j + 1, 2), dtype=torch.float32,
                      device=wj.device)
    _check(lib.lz3_pass1(B, wj.shape[-3], mode, scal.data_ptr(),
                         wj.data_ptr(),
                         _ptrs(prev), j, *wts,
                         w.data_ptr(), partial.data_ptr(), raw.data_ptr(),
                         nz, ny, nx,
                         float(desc["scale"]) * float(desc["sign"]),
                         _stream(wj)), "pass1_3d")
    pass1_3d.launches += 1
    return w, raw


pass1_3d.launches = 0


# pass1_shard3d's bricks (csrc/lanczos3d.cu): a tile of nxt columns (a
# power of two, 4 to SHARD3D_MAX_COLS) by tyt rows, four points per thread,
# (nxt / 4) tyt threads (a multiple of 32, at most SHARD3D_THREADS), over
# pz planes; in shared memory a ring of three field planes of P planes and,
# aniso, four planes of face weights, tyt + 2 rows each.
SHARD3D_THREADS = 256          # lanczos3d.cu ST
SHARD3D_PER_SM = 3             # bricks resident on each SM (SHARD_PER_SM:
                               # the 16-byte forms, j <= 8)
SHARD3D_MAX_COLS = 64
SHARD3D_MAX_ROWS = 64
SHARD3D_SMS = 132              # the H100's SMs
SHARD3D_MIN_PLANES = 4
SHARD3D_SMEM_MAX = 232448 - 8192   # lanczos3d.cu SMEM_MAX


def shard3d_tiles(nz, ny, nx, P, aniso, vec):
    """The bricks of a pass1_shard3d launch on one lane of an (nz, ny, nx)
    block: dict(nxt, tyt, pz, threads, blocks, smem).

    nxt: the narrowest power of two (4 to SHARD3D_MAX_COLS) that holds the
    block's width, so that every thread owns four columns of points
    whatever the width; tyt: rows to SHARD3D_THREADS threads (at most
    SHARD3D_MAX_ROWS, and no more than ny needs, in steps that keep the
    threads a multiple of 32); pz: the planes of a brick, the depth at
    which the bricks of one lane take the fewest plane steps on the busiest
    SM, SHARD3D_PER_SM of them on each SM at a time (a brick copies pz + 2
    planes), and of those the deepest, at least SHARD3D_MIN_PLANES (a
    brick's start, three planes copied before its first step, is not
    overlapped). blocks: bricks per lane (the partial-sum rows of a lane,
    x tiles fastest, then y, then z); smem: bytes of the ring (`vec`: the
    16-byte form's rows). Depends on the block's shape and form only, never
    on the batch.
    """
    nxt = 4
    while nxt < min(nx, SHARD3D_MAX_COLS):
        nxt *= 2
    tpr = nxt // 4
    step = max(1, 32 // tpr)
    tyt = min(SHARD3D_THREADS // tpr, SHARD3D_MAX_ROWS,
              -(-ny // step) * step)
    tiles = -(-nx // nxt) * -(-ny // tyt)
    slots = SHARD3D_SMS * SHARD3D_PER_SM
    pz = min(range(min(nz, SHARD3D_MIN_PLANES), nz + 1), key=lambda q: (
        -(-tiles * -(-nz // q) // slots) * (q + 2), -q))
    sw = nxt + 8 if vec else nxt + 2
    smem = (3 * P + 4 * bool(aniso)) * (tyt + 2) * sw * 4
    return dict(nxt=nxt, tyt=tyt, pz=pz, threads=tpr * tyt,
                blocks=_bricks(nz, ny, nx, nxt, tyt, pz), smem=smem)


def _bricks(nz, ny, nx, nxt, tyt, pz):
    """pass1_shard3d's bricks per lane (lanczos3d.cu shard_tiles)."""
    return -(-nx // nxt) * -(-ny // tyt) * -(-nz // pz)


def shard3d_scratch(nz, ny, nx, t, B, j):
    """Floats of pass1_shard3d's partial-sum scratch for bricks t (nxt,
    tyt, pz) on B lanes at iteration j: a row of 2 (j + 1) sums per brick
    of each lane."""
    return B * _bricks(nz, ny, nx, t["nxt"], t["tyt"], t["pz"]) * 2 * (j + 1)


def pass1_shard3d(scal, wj, prev, yh, zh, xh, d):
    """K9-K12 and K1' in modes shard3d, shard3d_aniso: pass1_3d on one
    shard's block of a sharded 3D grid, the merged (P, R, nx) view of a
    (lnz, lny, nx) block.

    yh (P, 2, lnz, nx), zh (P, 2, lny, nx) and xh (P, 2, R) are the halos
    of _stencil_shard3d_ref; `d` describes the shard's operator: kind
    "shard3d" (variant, offsets z0, y0, x0, global NZ, NY, NX) or
    "shard3d_aniso" (face weights wx, wy, wz (R, nx), wxl (R), wyh (lnz, nx),
    wzh (lny, nx)), lnz, lny, scale and sign. Returns (w, raw) as pass1_3d.
    A batch of B lanes of the block: fields (B, P, R, nx), scal (B, 1, 2),
    halos and face weights with a leading B, raw (B, j+1, 2), in one launch
    whose lane b gives the bits of the launch on lane b alone. The bricks
    are shard3d_tiles' (the kernel refuses bricks it cannot run).
    """
    what = "pass1_shard3d"
    j = len(prev)
    if j + 1 > MAX_M:
        raise ValueError(f"{what}: at most {MAX_M} columns, got {j + 1}")
    if not use_kernel(wj):
        return pass1_shard3d_ref(scal, wj, prev, yh, zh, xh, d)
    B = _check_fields([wj, *prev], wj, what)
    _check_scalars(scal, (1, 2), wj, what)
    P, R, nx = wj.shape[-3:]
    lead = tuple(wj.shape[:-3])
    nz, ny = d["lnz"], d["lny"]
    if nz * ny != R or min(nz, ny, nx) < 2:
        raise ValueError(f"{what}: field {tuple(wj.shape)} is not the merged "
                         f"view of a ({nz}, {ny}, {nx}) block with sides >= 2")
    _check_aux(yh, lead + (P, 2, nz, nx), wj, what, "yh")
    _check_aux(zh, lead + (P, 2, ny, nx), wj, what, "zh")
    _check_aux(xh, lead + (P, 2, R), wj, what, "xh")
    aniso = d["kind"] == "shard3d_aniso"
    if aniso:
        wts = [_check_aux(d[k], lead + shp, wj, what, k).data_ptr()
               for k, shp in (("wx", (R, nx)), ("wy", (R, nx)),
                              ("wz", (R, nx)), ("wxl", (R,)),
                              ("wyh", (nz, nx)), ("wzh", (ny, nx)))]
        mode = _MODES["aniso"]
    else:
        wts = [None] * 6
        mode = _MODES[d["variant"]]
    lib = _lib()
    w = torch.empty_like(wj)
    # the 16-byte form: every pointer it reads rows from 16-byte aligned
    # (xh and wxl are read a float at a time)
    vec = int(nx % 4 == 0 and all(
        p % 16 == 0 for p in [x.data_ptr() for x in (wj, w, yh, zh, *prev)]
        + [p for p in wts[:3] + wts[4:] if p is not None]))
    t = shard3d_tiles(nz, ny, nx, P, aniso, vec)
    partial = torch.empty(shard3d_scratch(nz, ny, nx, t, B, j),
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty(lead + (j + 1, 2), dtype=torch.float32,
                      device=wj.device)
    _check(lib.lz3_pass1_shard(
        B, P, mode, vec, scal.data_ptr(), wj.data_ptr(), _ptrs(prev), j,
        *wts, yh.data_ptr(), zh.data_ptr(), xh.data_ptr(), w.data_ptr(),
        partial.data_ptr(), raw.data_ptr(), nz, ny, nx,
        *(int(d.get(k, 0)) for k in ("z0", "y0", "x0", "NZ", "NY", "NX")),
        float(d["scale"]) * float(d["sign"]), t["nxt"], t["tyt"], t["pz"],
        _stream(wj)), what)
    pass1_shard3d.launches += 1
    return w, raw


pass1_shard3d.launches = 0


def pass2(q, w, W):
    """w' = w - sum_{i<=j} q_i W_i (complex q_i as (re, im) rows of the
    (j+1, 2) float32 q) and ||w'||^2 as a (1, 1) tensor; any planar
    (P, rows, nx) fields. Returns (w', nsq). A batch of B lanes: fields
    (B, P, rows, nx), q (B, j+1, 2), nsq (B, 1, 1), in one launch.

    With no columns (W empty; q is not read and may be None) the norm-only
    form: (w, ||w||^2), no field written. It is the start norm of the 3D
    two-pass loop, from pass2's grid-stride map and reduction order, so a
    lane's norm has the same bits in a batch and alone.
    """
    nw = len(W)
    if nw > MAX_M:
        raise ValueError(f"pass2: at most {MAX_M} columns, got {nw}")
    if not use_kernel(w):
        return pass2_ref(q, w, W)
    B = _check_fields([w, *W], w, "pass2")
    if nw:
        _check_scalars(q, (nw, 2), w, "pass2")
    lib = _lib()
    wn = torch.empty_like(w) if nw else None
    partial = torch.empty(lib.lz3_pass2_blocks() * B, dtype=torch.float32,
                          device=w.device)
    nsq = torch.empty(tuple(w.shape[:-3]) + (1, 1), dtype=torch.float32,
                      device=w.device)
    _check(lib.lz3_pass2(B, w.shape[-3], q.data_ptr() if nw else None,
                         w.data_ptr(), _ptrs(W) if nw else None, nw,
                         wn.data_ptr() if nw else None, partial.data_ptr(),
                         nsq.data_ptr(), w.shape[-2] * w.shape[-1],
                         _stream(w)), "pass2")
    pass2.launches += 1
    return (wn if nw else w), nsq


pass2.launches = 0


# K8's bricks: PIPE3D_COLS columns by PIPE3D_ROWS rows (csrc/lanczos3d.cu
# TY3: one rebuilt row per warp of its 8) by pz planes
PIPE3D_COLS = 128
PIPE3D_ROWS = 6


def pipe3d_brick(nz, ny, nx, fit):
    """(pz, grid) of a K8 launch on an (nz, ny, nx) grid: bricks of pz
    planes, walked by `grid` blocks, `fit` of which fit on the card at once.

    The busiest block walks ceil(bricks / grid) bricks of pz + 2 plane
    steps (a halo plane on each side); pz is the one that makes that the
    fewest steps, and of those the longest bricks (the fewest halo planes).
    """
    cols_rows = -(-nx // PIPE3D_COLS) * -(-ny // PIPE3D_ROWS)
    best = None
    for pz in range(1, nz + 1):
        bricks = cols_rows * -(-nz // pz)
        key = (-(-bricks // fit) * (pz + 2), -pz)
        if best is None or key < best[0]:
            best = (key, pz, min(bricks, fit))
    return best[1:]


_brick_cache = {}


def _brick(P, mode, nw, vec, nz, ny, nx):
    """pipe3d_brick for the kernel instantiation a call takes, the blocks
    that fit read from the library once."""
    key = (P, mode, _bucket(nw), vec, nz, ny, nx)
    if key not in _brick_cache:
        fit = _lib().lz3_pipe3d_fit(P, mode, nw, vec)
        if fit < 1:
            raise RuntimeError("pipe_3d: no block of the kernel fits on the "
                               "card")
        _brick_cache[key] = pipe3d_brick(nz, ny, nx, fit)
    return _brick_cache[key]


def pipe_3d(scal, av, W, desc):
    """K8: one pipelined 3D Lanczos iteration j = len(W) - 1 on the merged
    (P, R, nx) view, pass2(j) fused with pass1(j+1).

    scal: (j+2, 2) float32 [(s_j, 0), c_0..c_j] (complex c_i); av: av_j;
    W: W_0..W_j. Returns (W_{j+1}, av_{j+1}, nsq (1,1), gram (j+1,2),
    d (j+2,2)), the outputs of the Pallas _pipe3d_call in its order. A batch
    of B lanes: fields (B, P, R, nx), every scalar array with a leading B,
    aniso weights (B, R, nx), in one launch whose lane b gives the bits of
    the launch on lane b alone.
    """
    nw = len(W)
    if nw + 1 > MAX_M:
        raise ValueError(f"pipe_3d: at most {MAX_M} columns, got {nw + 1}")
    if not use_kernel(av):
        return pipe_3d_ref(scal, av, W, desc)
    B = _check_fields([av, *W], av, "pipe_3d")
    _check_scalars(scal, (nw + 1, 2), av, "pipe_3d")
    nz, ny, nx = _geom(desc, av, "pipe_3d")
    mode, wts = _mode_weights(desc, av, "pipe_3d")
    lib = _lib()
    P = av.shape[-3]
    lead = tuple(av.shape[:-3])
    nout = 1 + 2 * nw + 2 * (nw + 1)
    wn = torch.empty_like(av)
    avn = torch.empty_like(av)
    vec = int(nx % 4 == 0 and all(
        p % 16 == 0 for p in [t.data_ptr() for t in (av, wn, avn, *W)]
        + [w for w in wts if w is not None]))
    pz, grid = _brick(P, mode, nw, vec, nz, ny, nx)
    partial = torch.empty(B * grid * nout, dtype=torch.float32,
                          device=av.device)
    red = torch.empty(lead + (nout,), dtype=torch.float32, device=av.device)
    _check(lib.lz3_pipe3d(B, P, mode, vec, scal.data_ptr(), av.data_ptr(),
                          _ptrs(W), nw, *wts, wn.data_ptr(), avn.data_ptr(),
                          partial.data_ptr(), red.data_ptr(), nz, ny, nx,
                          float(desc["scale"]) * float(desc["sign"]), pz,
                          grid, _stream(av)), "pipe_3d")
    pipe_3d.launches += 1
    return (wn, avn, red[..., :1].view(lead + (1, 1)),
            red[..., 1:1 + 2 * nw].view(lead + (nw, 2)),
            red[..., 1 + 2 * nw:].view(lead + (nw + 1, 2)))


pipe_3d.launches = 0


# ------------------------------------------------------------ Lanczos driver

def lanczos_twopass(u, desc, m, fused=False):
    """The normalized two-pass Lanczos loop on a planar (P, rows, nx)
    float32 field, with the scalar recurrence kept on the device (no
    .item()): per iteration pass1_3d, then pass2 (3D; the JAX package's
    lanczos3d_pipe.lanczos_twopass3d_y), or with `fused` one K5 iter_step
    (2D or 3D; the _FUSED_ITER branch of its lanczos2d.lanczos_planar),
    whose alpha_j is s_j raw_j.

    Both loops also take a batch (B, P, rows, nx): every lane runs through
    the same launches and every scalar carries a leading B (the per-lane
    arithmetic is the same elementwise ops). The start norm is pass2's
    norm-only form, one launch, so that a lane's bits do not depend on the
    batch.

    Returns (W, s, alpha, beta, beta0) with the semantics of
    lanczos2d.lanczos_planar.
    """
    lead = tuple(u.shape[:-3])
    beta0 = torch.sqrt(pass2(None, u, [])[1][..., 0, 0])
    W, s = [u], [safe_inv(beta0)]
    alphas, betas = [], []
    zero = torch.zeros(lead, dtype=torch.float32, device=u.device)
    for j in range(m - 1):
        bs = betas[j - 1] * s[j - 1] if j > 0 else zero
        if fused:
            scal = torch.stack([s[j], bs] + s, dim=-1)[..., None, :]
            wn, raw, nsq = iter_step(scal, W[j], W[:j], desc)
            alphas.append(s[j] * raw[..., j, 0])
        else:
            scal = torch.stack([s[j], bs], dim=-1)[..., None, :]
            w, raw = pass1_3d(scal, W[j], W[:j], desc)
            sv = torch.stack(s, dim=-1)                      # ([B,] j+1)
            proj = sv[..., :, None] * raw
            alphas.append(proj[..., j, 0])
            q = sv[..., :, None] * proj
            wn, nsq = pass2(q, w, W[:j + 1])
        b = torch.sqrt(nsq[..., 0, 0])
        W.append(wn)
        s.append(safe_inv(b))
        betas.append(b)
    return W, s, alphas, betas, beta0
