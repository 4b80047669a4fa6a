"""Two-pass fused Lanczos for the 3D no-flux operators (iso3d, aniso3d).

Port of nlsolvers_tpu/ops/pallas/lanczos3d_pipe.py (`lanczos_twopass3d_y`)
and of the 3D parts of lanczos2d.lanczos_planar. State is PLANAR float32 on
the merged row view: a complex (nz, ny, nx) field is (2, R, nx) with
R = nz * ny, a real one (1, R, nx). Krylov columns W_i stay UNNORMALIZED
with their inverse norms s_i tracked as scalars, as in the 2D loop.

Two hand-written CUDA kernels (csrc/lanczos3d.cu) carry the loop; each has
its plain PyTorch version beside it and a launch counter on its wrapper:

  pass1_3d / pass1_3d_ref   replaces lanczos3d_pipe._pass1y_call and
                            _pass1zy_call, and lanczos2d._pass1_call in
                            modes iso3d/aniso3d
  pass2    / pass2_ref      replaces lanczos2d._pass2_call

The final sum reuses lanczos2d's `combine` on the merged view, and the
ghost copy after the step is ops/cuda/bc3d.py. A wrapper launches its
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
                                                    _check_fields,
                                                    _check_scalars, _dots,
                                                    _ptrs, _stream, safe_inv)

__all__ = ["supported_desc", "lanczos_twopass3d", "pass1_3d",
           "pass1_3d_ref", "pass2", "pass2_ref"]

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
            ("lz3_pass1", [i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, vp, vp,
                           i32, i32, i32, f32, vp]),
            ("lz3_pass2", [i32, vp, vp, pp, i32, vp, vp, vp, i64, vp]),
            ("lz3_bc3d", [i32, vp, i32, i32, i32, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    lib.lz3_error_string.argtypes = [i32]
    lib.lz3_error_string.restype = ctypes.c_char_p
    if lib.lz3_max_cols() != MAX_M:
        raise RuntimeError("csrc/lanczos3d.cu MAXCOLS differs from MAX_M")
    _lib_cache.append(lib)
    return lib


def _check(err, what):
    if err != 0:
        msg = _lib().lz3_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _geom(desc, like, what):
    nz, ny, nx = desc["nz"], desc["ny"], desc["nx"]
    if tuple(like.shape[1:]) != (nz * ny, nx):
        raise ValueError(f"{what}: field {tuple(like.shape)} is not the "
                         f"merged (P, {nz * ny}, {nx}) view of the operator's "
                         f"({nz}, {ny}, {nx}) grid")
    return nz, ny, nx


def _weights(desc, like, what):
    ws = [desc[k] for k in ("wx", "wy", "wz")]
    for w in ws:
        if (not isinstance(w, torch.Tensor) or w.dtype != torch.float32
                or w.device != like.device or not w.is_contiguous()
                or tuple(w.shape) != tuple(like.shape[1:])):
            raise ValueError(f"{what}: face weights must be contiguous "
                             f"float32 {tuple(like.shape[1:])} tensors on "
                             f"{like.device}")
    return ws


# ------------------------------------------------------------ plain versions

def _shift_rows(u, k):
    """v[:, r] = u[:, r - k] where 0 <= r - k < R, else 0 (k may be < 0)."""
    z = torch.zeros_like(u[:, :abs(k)])
    if k > 0:
        return torch.cat([z, u[:, :-k]], dim=1)
    return torch.cat([u[:, -k:], z], dim=1)


def _shift_cols(u, k):
    """v[..., x] = u[..., x - k] where that column exists, else 0 (k = +-1)."""
    z = torch.zeros_like(u[..., :1])
    if k > 0:
        return torch.cat([z, u[..., :-1]], dim=-1)
    return torch.cat([u[..., 1:], z], dim=-1)


def _stencil3d_ref(u, desc):
    """The operator of `desc` on a planar (P, R, nx) field, merged view;
    the arithmetic order of lanczos3d_pipe._stencil_3d_y /
    _stencil_aniso_3d_y."""
    nz, ny, nx = desc["nz"], desc["ny"], desc["nx"]
    ss = float(desc["scale"]) * float(desc["sign"])
    if desc["kind"] == "aniso_laplacian_3d":
        wx, wy, wz = (desc[k].to(u.device) for k in ("wx", "wy", "wz"))
        fx = wx * (_shift_cols(u, -1) - u)
        fx_l = _shift_cols(fx, 1)
        fy = wy * (_shift_rows(u, -1) - u)
        fy_m1 = _shift_rows(wy[None], 1) * (u - _shift_rows(u, 1))
        fz = wz * (_shift_rows(u, -ny) - u)
        fz_m = _shift_rows(wz[None], ny) * (u - _shift_rows(u, ny))
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
    w = scal[0, 0] * _stencil3d_ref(wj, desc)
    if prev:
        w = w - scal[0, 1] * prev[-1]
    raw = torch.stack([_dots(wi, w) for wi in list(prev) + [wj]])
    return w, raw


def pass2_ref(q, w, W):
    """Plain version of pass2."""
    a0 = w[0]
    a1 = w[1] if w.shape[0] == 2 else None
    for i, wi in enumerate(W):
        qr = q[i, 0]
        if a1 is None:
            a0 = a0 - qr * wi[0]
        else:
            qi = q[i, 1]
            a0 = a0 - (qr * wi[0] - qi * wi[1])
            a1 = a1 - (qr * wi[1] + qi * wi[0])
    wn = a0[None] if a1 is None else torch.stack([a0, a1])
    return wn, torch.sum(wn * wn).reshape(1, 1)


# ------------------------------------------------------------ kernel wrappers

def pass1_3d(scal, wj, prev, desc):
    """w = s_j A(W_j) - bs W_{j-1} and raw (j+1, 2) = <W_i, w>, i <= j, for
    the 3D operator of `desc` on the merged (P, R, nx) view.

    scal: (1, 2) float32 [s_j, bs] on the fields' device; wj: W_j;
    prev: W_0..W_{j-1} (j = len(prev) >= 0). Returns (w, raw).
    """
    j = len(prev)
    if j + 1 > MAX_M:
        raise ValueError(f"pass1_3d: at most {MAX_M} columns, got {j + 1}")
    if not use_kernel(wj):
        return pass1_3d_ref(scal, wj, prev, desc)
    _check_fields([wj, *prev], wj, "pass1_3d")
    _check_scalars(scal, (1, 2), wj, "pass1_3d")
    nz, ny, nx = _geom(desc, wj, "pass1_3d")
    aniso = desc["kind"] == "aniso_laplacian_3d"
    mode = _MODES["aniso" if aniso else desc["variant"]]
    wx, wy, wz = (_weights(desc, wj, "pass1_3d") if aniso
                  else (None, None, None))
    lib = _lib()
    nout = 2 * (j + 1)
    w = torch.empty_like(wj)
    partial = torch.empty(lib.lz3_pass1_blocks(nz, ny, nx) * nout,
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty((j + 1, 2), dtype=torch.float32, device=wj.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    _check(lib.lz3_pass1(wj.shape[0], mode, scal.data_ptr(), wj.data_ptr(),
                         _ptrs(prev), j, ptr(wx), ptr(wy), ptr(wz),
                         w.data_ptr(), partial.data_ptr(), raw.data_ptr(),
                         nz, ny, nx,
                         float(desc["scale"]) * float(desc["sign"]),
                         _stream(wj)), "pass1_3d")
    pass1_3d.launches += 1
    return w, raw


pass1_3d.launches = 0


def pass2(q, w, W):
    """w' = w - sum_{i<=j} q_i W_i (complex q_i as (re, im) rows of the
    (j+1, 2) float32 q) and ||w'||^2 as a (1, 1) tensor; any planar
    (P, rows, nx) fields. Returns (w', nsq)."""
    nw = len(W)
    if nw > MAX_M:
        raise ValueError(f"pass2: at most {MAX_M} columns, got {nw}")
    if not use_kernel(w):
        return pass2_ref(q, w, W)
    _check_fields([w, *W], w, "pass2")
    _check_scalars(q, (nw, 2), w, "pass2")
    lib = _lib()
    wn = torch.empty_like(w)
    partial = torch.empty(lib.lz3_pass2_blocks(), dtype=torch.float32,
                          device=w.device)
    nsq = torch.empty((1, 1), dtype=torch.float32, device=w.device)
    _check(lib.lz3_pass2(w.shape[0], q.data_ptr(), w.data_ptr(), _ptrs(W),
                         nw, wn.data_ptr(), partial.data_ptr(),
                         nsq.data_ptr(), w[0].numel(), _stream(w)), "pass2")
    pass2.launches += 1
    return wn, nsq


pass2.launches = 0


# ------------------------------------------------------------ Lanczos driver

def lanczos_twopass3d(u, desc, m):
    """Two-pass Lanczos on a planar (P, R, nx) float32 field: per iteration
    pass1_3d, then pass2 on the merged view, with the scalar recurrence of
    lanczos3d_pipe.lanczos_twopass3d_y kept on the device (no .item()).

    Returns (W, s, alpha, beta, beta0) with the semantics of
    lanczos2d.lanczos_planar.
    """
    f32 = dict(dtype=torch.float32, device=u.device)
    beta0 = torch.sqrt(torch.sum(u * u))
    W, s = [u], [safe_inv(beta0)]
    alphas, betas = [], []
    zero = torch.zeros((), **f32)
    for j in range(m - 1):
        bs = betas[j - 1] * s[j - 1] if j > 0 else zero
        scal = torch.stack([s[j], bs]).reshape(1, 2)
        w, raw = pass1_3d(scal, W[j], W[:j], desc)
        sv = torch.stack(s)                                  # (j+1,)
        proj = sv[:, None] * raw
        alphas.append(proj[j, 0])
        q = sv[:, None] * proj
        wn, nsq = pass2(q, w, W[:j + 1])
        b = torch.sqrt(nsq[0, 0])
        W.append(wn)
        s.append(safe_inv(b))
        betas.append(b)
    return W, s, alphas, betas, beta0
