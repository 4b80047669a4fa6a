"""One whole 2D SS2 step of the NLSE in one kernel (port of
nlsolvers_tpu/ops/pallas/resident2d.py).

  ss2_resident_step / ss2_resident_step_ref   replaces resident2d.
                                              ss2_resident_step (K13)

On a planar (2, ny, nx) float32 field: the first half kick
exp(i dt/2 rho(u)), exp(i dt L) by m-step Lanczos with full
reorthogonalization and a Taylor series for exp(i dt T) e1, the second
half kick (rho of the combined field), and the no-flux ghost ring. The
Taylor degree follows from theta = |dt| 8 |scale| (the spectrum of dt L
lies in [-theta, 0]) for a truncation error < 1e-8, so the step needs no
eigendecomposition and no host sync. `supported_resident` keeps the JAX
package's numeric gates (the 5-point Laplacian in its reference or clean
variant, complex64, theta <= 3.5, m <= MAX_M) and drops its TPU-geometry
ones (nx a multiple of 128, ny of 8, the basis within 112 MiB of VMEM): the
kernel masks ragged edges, and its basis lives in device memory.

The wrapper launches the kernel (csrc/resident2d.cu, a cooperative launch)
for a CUDA tensor under config.kernel_mode "auto" and raises if it cannot
run; a CPU tensor, or "off", takes the plain version. The kernel's Lanczos
loop is the default path's pipelined recurrence (lanczos2d._lanczos_pipe),
the plain version's the Pallas kernel's two-pass Gram-Schmidt: the same
exact result, other float32 rounding. The scratch (scratch_shapes) is
allocated at the first launch into the `scratch` dict the caller passes,
and reused by every later step that passes the same dict.
"""

import ctypes

import numpy as np
import torch

from nlsolvers_tpu_torch.config import use_kernel
from nlsolvers_tpu_torch.ops.boundaries import neumann_no_velocity_2d
from nlsolvers_tpu_torch.ops.cuda import _build
from nlsolvers_tpu_torch.ops.cuda.lanczos2d import (MAX_M, _stencil_ref,
                                                    _stream, safe_inv)
from nlsolvers_tpu_torch.utils.profiling import spanned

__all__ = ["supported_resident", "scratch_shapes", "ss2_resident_step",
           "ss2_resident_step_ref", "THETA_MAX"]

THETA_MAX = 3.5
_KINDS = {"cubic": 0, "cubic_quintic": 1, "saturable": 2}


def _taylor_degree(theta):
    """Smallest degree d with theta^(d+1)/(d+1)! < 1e-8 (exp(i theta) has
    unit modulus, so the truncation error is absolute ~= relative)."""
    err = theta
    d = 1
    while err > 1e-8 and d < 30:
        d += 1
        err = err * theta / (d + 1)
    return max(d, 4)


def _theta(desc, dt):
    return abs(dt) * 8.0 * abs(desc["scale"] * desc["sign"])


def supported_resident(desc, u_shape, dtype, m, dt):
    """Can the resident step run this configuration? u_shape is the grid
    (ny, nx); any grid with sides >= 3 qualifies."""
    if desc is None or desc.get("kind") != "laplacian_2d":
        return False
    if desc.get("variant") not in ("reference", "clean"):
        return False
    if dtype != torch.complex64:
        return False
    ny, nx = desc["ny"], desc["nx"]
    if tuple(u_shape) != (ny, nx) or ny < 3 or nx < 3:
        return False
    if not 1 <= m <= MAX_M:
        return False
    return _theta(desc, dt) <= THETA_MAX


# ------------------------------------------------------------ plain version

def _rho(kind, mfld, re, im, sigma1, sigma2, kappa):
    a2 = re * re + im * im
    if kind == "cubic":
        return mfld * a2
    if kind == "cubic_quintic":
        return mfld * (sigma1 * a2 + sigma2 * a2 * a2)
    return mfld * a2 / (1.0 + kappa * a2)


def _phase_mul(re, im, rho, half_dt):
    c, s = torch.cos(half_dt * rho), torch.sin(half_dt * rho)
    return re * c - im * s, re * s + im * c


def ss2_resident_step_ref(u, m_field, desc, dt, m, kind="cubic", sigma1=1.0,
                          sigma2=-0.1, kappa=1.0, apply_bc=True):
    """Plain version of ss2_resident_step, in the order of operations of
    the Pallas kernel."""
    half_dt = float(np.float32(0.5 * dt))
    re1, im1 = _phase_mul(u[0], u[1],
                          _rho(kind, m_field, u[0], u[1], sigma1, sigma2,
                               kappa), half_dt)
    W = [torch.stack([re1, im1])]
    beta0 = torch.sqrt(torch.sum(re1 * re1) + torch.sum(im1 * im1))
    sv = [safe_inv(beta0)]
    alphas, betas = [], []
    for j in range(m - 1):
        w = sv[j] * _stencil_ref(W[j], desc)
        if j > 0:
            w = w - (betas[j - 1] * sv[j - 1]) * W[j - 1]
        wre, wim = w[0], w[1]
        qs = []
        for i in range(j + 1):
            vr, vi = W[i][0], W[i][1]
            raw_re = torch.sum(vr * wre) + torch.sum(vi * wim)
            raw_im = torch.sum(vr * wim) - torch.sum(vi * wre)
            if i == j:
                alphas.append(sv[j] * raw_re)
            si2 = sv[i] * sv[i]
            qs.append((si2 * raw_re, si2 * raw_im))
        accr, acci = wre, wim
        for i, (qr, qi) in enumerate(qs):
            vr, vi = W[i][0], W[i][1]
            accr = accr - (qr * vr - qi * vi)
            acci = acci - (qr * vi + qi * vr)
        b = torch.sqrt(torch.sum(accr * accr) + torch.sum(acci * acci))
        betas.append(b)
        sv.append(safe_inv(b))
        W.append(torch.stack([accr, acci]))
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    alpha = torch.stack(alphas + [zero])              # T(m-1, m-1) stays 0
    beta = torch.stack(betas) if betas else zero[None][:0]

    # exp(i dt T) e1: t_k = (i dt / k) T t_{k-1}, rows as in the kernel
    tre = torch.zeros(m, dtype=torch.float32, device=u.device)
    tre[0] = 1.0
    tim = torch.zeros_like(tre)
    yre, yim = tre.clone(), tim.clone()
    for k in range(1, _taylor_degree(_theta(desc, dt)) + 1):
        ar, ai = alpha * tre, alpha * tim
        ar[1:] = ar[1:] + beta * tre[:-1]
        ai[1:] = ai[1:] + beta * tim[:-1]
        ar[:-1] = ar[:-1] + beta * tre[1:]
        ai[:-1] = ai[:-1] + beta * tim[1:]
        f = float(np.float32(dt / k))
        tre, tim = -f * ai, f * ar
        yre, yim = yre + tre, yim + tim
    svt = torch.stack(sv)
    cr, ci = beta0 * svt * yre, beta0 * svt * yim

    outr = torch.zeros_like(re1)
    outi = torch.zeros_like(im1)
    for i in range(m):
        vr, vi = W[i][0], W[i][1]
        outr = outr + cr[i] * vr - ci[i] * vi
        outi = outi + cr[i] * vi + ci[i] * vr
    outr, outi = _phase_mul(outr, outi,
                            _rho(kind, m_field, outr, outi, sigma1, sigma2,
                                 kappa), half_dt)
    out = torch.stack([outr, outi])
    return neumann_no_velocity_2d(out) if apply_bc else out


# ------------------------------------------------------------ kernel wrapper

_lib_cache = []


def _lib():
    if _lib_cache:
        return _lib_cache[0]
    lib = _build.library("resident2d")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args, ret in (
            ("rs_max_cols", [], i32),
            ("rs_partial_floats", [], ctypes.c_longlong),
            ("rs_step", [vp, vp, vp, vp, vp, vp, i32, i32, i32, f32, i32,
                         ctypes.c_double, f32, i32, i32, f32, f32, f32, i32,
                         vp], i32)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ret
    lib.rs_error_string.argtypes = [i32]
    lib.rs_error_string.restype = ctypes.c_char_p
    if lib.rs_max_cols() != MAX_M:
        raise RuntimeError("csrc/resident2d.cu MAXCOLS differs from MAX_M")
    _lib_cache.append(lib)
    return lib


def scratch_shapes(m, ny, nx, partial_floats):
    """The shapes of one problem's scratch: the (m, 2, ny, nx) basis, the
    two av columns the kernel alternates between, and the partial sums
    (two buffers, partial_floats in all, rs_partial_floats of the
    library)."""
    return {"basis": (m, 2, ny, nx), "avs": (2, 2, ny, nx),
            "partial": (partial_floats,)}


def _scratch(scratch, m, ny, nx, device):
    """The scratch of one problem's launches (scratch_shapes), allocated at
    the first launch into the caller's dict."""
    key = (m, ny, nx, str(device))
    if scratch.get("key") != key:
        scratch.clear()
        scratch["key"] = key
        shapes = scratch_shapes(m, ny, nx, _lib().rs_partial_floats())
        for name, shape in shapes.items():
            scratch[name] = torch.empty(shape, dtype=torch.float32,
                                        device=device)
    return scratch["basis"], scratch["avs"], scratch["partial"]


@spanned("nls.launch.ss2_resident_step")
def ss2_resident_step(u, m_field, desc, dt, m, kind="cubic", sigma1=1.0,
                      sigma2=-0.1, kappa=1.0, apply_bc=True, scratch=None):
    """K13: one full SS2 step on a planar (2, ny, nx) float32 field u.

    Equivalent to: u1 = e^{i dt/2 rho(u)} u; u2 = exp(i dt L) u1 (Lanczos
    m, full reorth); u3 = e^{i dt/2 rho(u2)} u2; the no-flux ghost copy when
    apply_bc. m_field: (ny, nx) float32 on u's device. `scratch`: a dict
    that keeps the basis across the steps of one problem (a new one is
    allocated per call without it). Returns a new (2, ny, nx) field.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    if u.dim() != 3 or u.shape[0] != 2:
        raise ValueError(f"ss2_resident_step: u must be planar (2, ny, nx), "
                         f"got {tuple(u.shape)}")
    ny, nx = u.shape[1:]
    if not supported_resident(desc, (ny, nx), torch.complex64, m, dt):
        raise ValueError("ss2_resident_step: configuration not supported "
                         "(see supported_resident)")
    if not use_kernel(u):
        return ss2_resident_step_ref(u, m_field, desc, dt, m, kind, sigma1,
                                     sigma2, kappa, apply_bc)
    for t, name in ((u, "u"), (m_field, "m_field")):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != u.device):
            raise ValueError(f"ss2_resident_step: {name} must be a "
                             f"contiguous float32 tensor on {u.device}")
    if tuple(m_field.shape) != (ny, nx):
        raise ValueError(f"ss2_resident_step: m_field "
                         f"{tuple(m_field.shape)} != {(ny, nx)}")
    basis, avs, partial = _scratch({} if scratch is None else scratch, m,
                                   ny, nx, u.device)
    out = torch.empty_like(u)
    err = _lib().rs_step(
        u.data_ptr(), m_field.data_ptr(), out.data_ptr(), basis.data_ptr(),
        avs.data_ptr(), partial.data_ptr(), m, ny, nx,
        float(desc["scale"]) * float(desc["sign"]),
        int(desc["variant"] == "clean"), float(dt),
        float(np.float32(0.5 * dt)), _taylor_degree(_theta(desc, dt)),
        _KINDS[kind], sigma1, sigma2, kappa, int(bool(apply_bc)), _stream(u))
    if err != 0:
        msg = _lib().rs_error_string(err).decode()
        raise RuntimeError(f"ss2_resident_step: CUDA error {err} ({msg})")
    ss2_resident_step.launches += 1
    return out


ss2_resident_step.launches = 0
