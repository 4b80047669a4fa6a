"""Fused Lanczos kernels for the 2D 5-point no-flux Laplacian (iso2d).

Port of the iso2d parts of nlsolvers_tpu/ops/pallas/lanczos2d.py. State is
PLANAR float32: a complex field is (2, ny, nx) (re, im planes), a real field
(1, ny, nx). Krylov columns W_i are kept UNNORMALIZED with their inverse
norms s_i tracked as scalars, so normalization folds into the next matvec.

The entry points (supported_desc, lanczos_planar, matfunc_apply_planar*)
also serve the 3D kinds, whose loop is ops/cuda/lanczos3d.py.

Three hand-written CUDA kernels (csrc/lanczos2d.cu) carry the 2D loop; each
has its plain PyTorch version beside it and a launch counter on its wrapper:

  pass1_iso2d / pass1_iso2d_ref   replaces _pass1_call (mode iso2d)
  pipe_iso2d  / pipe_iso2d_ref    replaces _pipe_call (mode iso2d)
  combine     / combine_ref       replaces _combine_call

A wrapper launches its kernel for a CUDA tensor under config.kernel_mode
"auto" and raises if the kernel cannot run; it takes the plain version for a
CPU tensor, or under "off". What bounds the kernels, and what their design
does about it, is in the header of csrc/lanczos2d.cu.

The scalar recurrence between the kernels (_lanczos_pipe) runs as 0-d/1-d
torch ops on the device, with no .item(); the one host sync left in a
matrix function is torch.linalg.eigh's (PERF.md).
"""

import ctypes

import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops import krylov
from nlsolvers_tpu_torch.ops.cuda import _build

__all__ = ["matvec_descriptor", "supported_desc", "lanczos_planar",
           "matfunc_apply_planar", "matfunc_apply_planar_multi",
           "pass1_iso2d", "pass1_iso2d_ref", "pipe_iso2d", "pipe_iso2d_ref",
           "combine", "combine_ref", "MAX_M", "MAX_SPECS", "KINDS_3D"]

# Longest basis (Krylov m) and most matrix functions per combine the kernels
# take: csrc/lanczos2d.cu's MAXCOLS and KMAX, checked when it is loaded.
MAX_M = 32
MAX_SPECS = 4


def matvec_descriptor(kind, shape, scale, sign=1.0, variant="reference"):
    """Static description of a stencil operator the fused kernels implement:
    kind "laplacian_2d" (5-point no-flux, reference or clean diagonal);
    `sign` multiplies the whole operator."""
    ny, nx = shape
    return dict(kind=kind, ny=int(ny), nx=int(nx), scale=float(scale),
                sign=float(sign), variant=variant)


# descriptor kinds whose Lanczos loop is ops/cuda/lanczos3d.py
KINDS_3D = ("laplacian_3d", "aniso_laplacian_3d")


def supported_desc(desc, u_shape, dtype):
    """Can the fused path run this operator/field combination? `u_shape` is
    the grid, (ny, nx) or (nz, ny, nx); the 3D kinds are lanczos3d's. The
    kernels mask ragged edges, so any grid with sides >= 3 qualifies."""
    if desc is not None and desc.get("kind") in KINDS_3D:
        from nlsolvers_tpu_torch.ops.cuda import lanczos3d
        return lanczos3d.supported_desc(desc, u_shape, dtype)
    if desc is None or desc.get("kind") != "laplacian_2d":
        return False
    if desc.get("variant") not in ("reference", "clean"):
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
            ("lz_max_cols", []),
            ("lz_max_specs", []),
            ("lz_pass1_iso2d",
             [i32, vp, vp, pp, i32, vp, vp, vp, i32, i32, f32, i32, vp]),
            ("lz_pipe_iso2d",
             [i32, i32, vp, vp, pp, i32, vp, vp, vp, vp, i32, i32, f32, i32,
              vp]),
            ("lz_combine", [i32, vp, pp, i32, i32, pp, i32, i32, vp])):
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
    P, ny, nx = like.shape
    if P not in (1, 2):
        raise ValueError(f"{what}: planar fields are (1|2, ny, nx), "
                         f"got {tuple(like.shape)}")
    for f in fields:
        if not isinstance(f, torch.Tensor) or f.dtype != torch.float32:
            raise TypeError(f"{what}: fields must be float32 tensors")
        if f.device != like.device:
            raise ValueError(f"{what}: fields on {f.device} and {like.device}")
        if tuple(f.shape) != (P, ny, nx):
            raise ValueError(f"{what}: field shape {tuple(f.shape)} != "
                             f"{(P, ny, nx)}")
        if not f.is_contiguous():
            raise ValueError(f"{what}: fields must be contiguous")


def _check_scalars(scal, shape, like, what):
    if (scal.dtype != torch.float32 or tuple(scal.shape) != shape
            or scal.device != like.device or not scal.is_contiguous()):
        raise ValueError(f"{what}: scalars must be a contiguous float32 "
                         f"{shape} tensor on {like.device}")


def _op_args(desc):
    return (float(desc["scale"]) * float(desc["sign"]),
            int(desc["variant"] == "clean"))


# ------------------------------------------------------------ plain versions

def _stencil_ref(u, desc):
    """5-point no-flux Laplacian of a planar (P, ny, nx) field: out-of-grid
    neighbours are 0, the variant diagonal comes from the indices."""
    P, ny, nx = u.shape
    rows = torch.arange(ny, device=u.device)[:, None]
    cols = torch.arange(nx, device=u.device)[None, :]
    top, bot = rows == 0, rows == ny - 1
    lft, rgt = cols == 0, cols == nx - 1
    if desc["variant"] == "reference":
        diag = torch.where(top | bot | lft | rgt, -3.0, -4.0).to(u.dtype)
    else:
        diag = -(4.0 - top.to(u.dtype) - bot.to(u.dtype) - lft.to(u.dtype)
                 - rgt.to(u.dtype))
    zr = torch.zeros_like(u[:, :1, :])
    zc = torch.zeros_like(u[:, :, :1])
    above = torch.cat([zr, u[:, :-1, :]], dim=1)
    below = torch.cat([u[:, 1:, :], zr], dim=1)
    left = torch.cat([zc, u[:, :, :-1]], dim=2)
    right = torch.cat([u[:, :, 1:], zc], dim=2)
    return (above + below + left + right + diag * u) * (
        float(desc["scale"]) * float(desc["sign"]))


def _dots(a, b):
    """Hermitian product <a, b> = sum conj(a) b of planar fields, (re, im)."""
    if a.shape[0] == 1:
        re = torch.sum(a[0] * b[0])
        return torch.stack([re, torch.zeros_like(re)])
    return torch.stack([torch.sum(a[0] * b[0] + a[1] * b[1]),
                        torch.sum(a[0] * b[1] - a[1] * b[0])])


def pass1_iso2d_ref(scal, wj, prev, desc):
    """Plain version of pass1_iso2d."""
    w = scal[0, 0] * _stencil_ref(wj, desc)
    if prev:
        w = w - scal[0, 1] * prev[-1]
    raw = torch.stack([_dots(wi, w) for wi in list(prev) + [wj]])
    return w, raw


def _rebuild_ref(scal, av, W):
    s = scal[0, 0]
    a0 = s * av[0]
    a1 = s * av[1] if av.shape[0] == 2 else None
    for i, wi in enumerate(W):
        cr = scal[1 + i, 0]
        if a1 is None:
            a0 = a0 - cr * wi[0]
        else:
            ci = scal[1 + i, 1]
            a0 = a0 - (cr * wi[0] - ci * wi[1])
            a1 = a1 - (cr * wi[1] + ci * wi[0])
    return a0[None] if a1 is None else torch.stack([a0, a1])


def pipe_iso2d_ref(scal, av, W, desc, last):
    """Plain version of pipe_iso2d."""
    wn = _rebuild_ref(scal, av, W)
    nsq = torch.sum(wn * wn).reshape(1, 1)
    gram = torch.stack([_dots(wi, wn) for wi in W])
    if last:
        return wn, nsq, gram
    avn = _stencil_ref(wn, desc)
    d = torch.stack([_dots(wi, avn) for wi in W] + [_dots(wn, avn)])
    return wn, avn, nsq, gram, d


def combine_ref(q, W):
    """Plain version of combine."""
    outs = []
    for spec in range(q.shape[0]):
        if W[0].shape[0] == 1:
            acc = q[spec, 0, 0] * W[0][0]
            for i in range(1, len(W)):
                acc = acc + q[spec, i, 0] * W[i][0]
            outs.append(acc[None])
            continue
        a, b = q[spec, 0, 0], q[spec, 0, 1]
        y0 = a * W[0][0] - b * W[0][1]
        y1 = a * W[0][1] + b * W[0][0]
        for i in range(1, len(W)):
            a, b = q[spec, i, 0], q[spec, i, 1]
            y0 = y0 + a * W[i][0] - b * W[i][1]
            y1 = y1 + a * W[i][1] + b * W[i][0]
        outs.append(torch.stack([y0, y1]))
    return tuple(outs)


# ------------------------------------------------------------ kernel wrappers

def pass1_iso2d(scal, wj, prev, desc):
    """K1: w = s_j A(W_j) - bs W_{j-1} and raw (j+1, 2) = <W_i, w>, i <= j.

    scal: (1, 2) float32 [s_j, bs] on the fields' device; wj: W_j;
    prev: W_0..W_{j-1} (j = len(prev) >= 0). Returns (w, raw).
    """
    j = len(prev)
    if j + 1 > MAX_M:
        raise ValueError(f"pass1_iso2d: at most {MAX_M} columns, got {j + 1}")
    if not use_kernel(wj):
        return pass1_iso2d_ref(scal, wj, prev, desc)
    _check_fields([wj, *prev], wj, "pass1_iso2d")
    _check_scalars(scal, (1, 2), wj, "pass1_iso2d")
    lib = _lib()
    P, ny, nx = wj.shape
    ss, clean = _op_args(desc)
    nout = 2 * (j + 1)
    w = torch.empty_like(wj)
    partial = torch.empty(lib.lz_num_blocks(ny, nx) * nout,
                          dtype=torch.float32, device=wj.device)
    raw = torch.empty((j + 1, 2), dtype=torch.float32, device=wj.device)
    _check(lib.lz_pass1_iso2d(P, scal.data_ptr(), wj.data_ptr(), _ptrs(prev),
                              j, w.data_ptr(), partial.data_ptr(),
                              raw.data_ptr(), ny, nx, ss, clean,
                              _stream(wj)), "pass1_iso2d")
    pass1_iso2d.launches += 1
    return w, raw


pass1_iso2d.launches = 0


def pipe_iso2d(scal, av, W, desc, last):
    """K2: one pipelined Lanczos iteration j = len(W) - 1.

    scal: (j+2, 2) float32 [(s_j, 0), c_0..c_j] (complex c_i); av: av_j;
    W: W_0..W_j. Returns (W_{j+1}, av_{j+1}, nsq (1,1), gram (j+1,2),
    d (j+2,2)), or (W_{j+1}, nsq, gram) when `last`.
    """
    nw = len(W)
    if nw + 1 > MAX_M:
        raise ValueError(f"pipe_iso2d: at most {MAX_M - 1} columns, got {nw}")
    if not use_kernel(av):
        return pipe_iso2d_ref(scal, av, W, desc, last)
    _check_fields([av, *W], av, "pipe_iso2d")
    _check_scalars(scal, (nw + 1, 2), av, "pipe_iso2d")
    lib = _lib()
    P, ny, nx = av.shape
    ss, clean = _op_args(desc)
    nout = 1 + 2 * nw + (0 if last else 2 * (nw + 1))
    wn = torch.empty_like(av)
    avn = None if last else torch.empty_like(av)
    partial = torch.empty(lib.lz_num_blocks(ny, nx) * nout,
                          dtype=torch.float32, device=av.device)
    red = torch.empty(nout, dtype=torch.float32, device=av.device)
    _check(lib.lz_pipe_iso2d(P, int(last), scal.data_ptr(), av.data_ptr(),
                             _ptrs(W), nw, wn.data_ptr(),
                             None if last else avn.data_ptr(),
                             partial.data_ptr(), red.data_ptr(), ny, nx, ss,
                             clean, _stream(av)), "pipe_iso2d")
    pipe_iso2d.launches += 1
    nsq = red[:1].view(1, 1)
    gram = red[1:1 + 2 * nw].view(nw, 2)
    if last:
        return wn, nsq, gram
    return wn, avn, nsq, gram, red[1 + 2 * nw:].view(nw + 1, 2)


pipe_iso2d.launches = 0


def combine(q, W):
    """K3: y_spec = sum_i q[spec, i] W_i (complex q, s_i folded in) for the
    k = q.shape[0] specs in one pass over the m = len(W) columns."""
    k, m = q.shape[0], len(W)
    if m > MAX_M or k > MAX_SPECS:
        raise ValueError(f"combine: at most {MAX_M} columns and {MAX_SPECS} "
                         f"specs, got {m} and {k}")
    if not use_kernel(W[0]):
        return combine_ref(q, W)
    _check_fields(W, W[0], "combine")
    _check_scalars(q, (k, m, 2), W[0], "combine")
    P, ny, nx = W[0].shape
    outs = [torch.empty_like(W[0]) for _ in range(k)]
    _check(_lib().lz_combine(P, q.data_ptr(), _ptrs(W), m, k, _ptrs(outs),
                             ny, nx, _stream(W[0])), "combine")
    combine.launches += 1
    return tuple(outs)


combine.launches = 0


# ------------------------------------------------------------ Lanczos driver

def safe_inv(nrm):
    """1/nrm, and 0 for a zero norm: a zero column (zero start vector or
    exact breakdown) then contributes nothing and the result stays finite."""
    pos = nrm > 0
    return torch.where(pos, 1.0 / torch.where(pos, nrm, torch.ones_like(nrm)),
                       torch.zeros_like(nrm))


def _lanczos_pipe(u, m, desc):
    """Pipelined single-pass Lanczos: K1 once, then K2 m-1 times.

    w_j = s_j av_j - bs W_{j-1} (bs = beta_{j-1} s_{j-1}) is never
    materialized: its projections raw_i = <W_i, w_j> are recovered as
    s_j d_i - bs <W_i, W_{j-1}>, with d_i = <W_i, av_j> from the previous
    kernel and the gram terms <W_i, W_{j-1}> from the kernel before that
    (i = j-1: beta_{j-2}^2; i = j: conj of the previous gram's last entry).
    The rebuild coefficients fold the recurrence term in:
    c_i = s_i^2 raw_i + (i == j-1) bs.
    """
    f32 = dict(dtype=torch.float32, device=u.device)
    zero = torch.zeros((), **f32)
    nsq0 = torch.sum(u * u)
    beta0 = torch.sqrt(nsq0)
    # init: av_0 = A(W_0) and d_0 = <W_0, av_0>, i.e. pass1 with [1, 0]
    av, d_prev = pass1_iso2d(torch.eye(1, 2, **f32), u, [], desc)
    W, s = [u], [safe_inv(beta0)]
    alphas, betas = [], []
    g_prev = g_prev2 = None
    for j in range(m - 1):
        sj = s[j]
        if j == 0:
            raw = sj * d_prev
            bs = zero
        else:
            bs = betas[j - 1] * s[j - 1]
            parts = [] if j < 2 else [g_prev2]               # i <= j-2
            nb2 = betas[j - 2] ** 2 if j >= 2 else nsq0      # i = j-1
            parts.append(torch.stack([nb2, zero])[None])
            parts.append(torch.stack([g_prev[j - 1, 0],      # i = j (conj)
                                      -g_prev[j - 1, 1]])[None])
            raw = sj * d_prev - bs * torch.cat(parts)
        sv = torch.stack(s)                                  # (j+1,)
        proj = sv[:, None] * raw
        alphas.append(proj[j, 0])
        c = sv[:, None] * proj
        if j > 0:
            c[j - 1, 0] += bs
        scal = torch.cat([torch.stack([sj, zero])[None], c])
        last = j == m - 2
        res = pipe_iso2d(scal, av, W, desc, last)
        if last:
            wn, nsq, gram = res
        else:
            wn, av, nsq, gram, d_prev = res
        b = torch.sqrt(nsq[0, 0])
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
    pipelined K1/K2 loop, 3D the two-pass loop of ops/cuda/lanczos3d.py.
    """
    three_d = desc is not None and desc.get("kind") in KINDS_3D
    grid = tuple(u.shape[1:])
    if three_d and grid == (desc.get("nz", 0) * desc.get("ny", 0),
                            desc.get("nx")):
        grid = (desc["nz"], desc["ny"], desc["nx"])      # the merged view
    if not supported_desc(desc, grid, torch.float32):
        raise NotImplementedError(
            f"fused Lanczos ports the 2D 5-point Laplacian and the 3D "
            f"operators (ROADMAP.md queue 1, item 7 for the rest), got a "
            f"{None if desc is None else desc.get('kind')} descriptor for a "
            f"{tuple(u.shape)} field")
    if m > MAX_M:
        raise ValueError(f"Krylov m={m} exceeds the kernels' {MAX_M}")
    if m > 1:
        if three_d:
            from nlsolvers_tpu_torch.ops.cuda import lanczos3d
            return lanczos3d.lanczos_twopass3d(u, desc, m)
        return _lanczos_pipe(u, m, desc)
    beta0 = torch.sqrt(torch.sum(u * u))
    return [u], [safe_inv(beta0)], [], [], beta0


def matfunc_apply_planar(u, desc, t, func, m):
    """y = f(t * sign*scale*L) u on a planar (P, ny, nx) float32 field (the
    merged (P, nz*ny, nx) view for the 3D kinds)."""
    return matfunc_apply_planar_multi(u, desc, ((t, func),), m)[0]


def matfunc_apply_planar_multi(u, desc, specs, m):
    """[f(t L) u for (t, f) in specs] from ONE fused-kernel Lanczos run and
    one combine pass; q[spec, i] = (Re coef_i s_i, Im coef_i s_i). Serves
    the 2D and the 3D kinds: combine is geometry-free."""
    W, s, alphas, betas, beta0 = lanczos_planar(u, desc, m)
    alpha, beta = krylov.tridiag_entries(alphas, betas, beta0, m,
                                         torch.float32)
    lam, Q = krylov.tridiag_eigh(alpha, beta)
    sv = torch.stack(s)
    rows = []
    for t, func in specs:
        coef = krylov.coefficients(func, t, lam, Q, beta0)
        if coef.is_complex():
            cr, ci = coef.real, coef.imag
        else:
            cr, ci = coef, torch.zeros_like(coef)
        rows.append(torch.stack([cr.to(torch.float32) * sv,
                                 ci.to(torch.float32) * sv], dim=-1))
    return combine(torch.stack(rows), W)
