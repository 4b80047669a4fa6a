"""Lanczos matrix-function core: y = f(t L) u for matrix-free operators.

Port of nlsolvers_tpu/ops/krylov.py: the generic path on any real or complex
dtype (complex128 included). Full reorthogonalization, the safe
normalization of a zero start vector, alpha[m-1] = 0 and the 1e-8 / 1e-12
guards of the function table are the JAX package's, which mirror the
reference (eigen_krylov_real.hpp, eigen_krylov_complex.hpp).

Precision: the projections below use torch.matmul. On a CUDA device a
float32 matmul may run in TF32 when torch.backends.cuda.matmul.allow_tf32 is
True; it is False by default and this package never sets it. The JAX
package pins HIGHEST precision for the same reason (krylov.py:49-55).

Operators that carry a `kernel_desc` and a supported shape and dtype are
dispatched to the fused kernels (ops/cuda/lanczos2d.py, lanczos3d.py) by
`_fused_path`.
"""

import numpy as np
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.config import default_krylov_m, real_dtype_of

__all__ = ["lanczos", "tridiag_eigh", "matfunc_apply", "matfunc_apply_multi",
           "expm_apply", "MATFUNCS"]


def _sinc(x):
    """sin(x)/x with the reference's 1e-8 guard (eigen_krylov_real.hpp:93)."""
    small = torch.abs(x) < 1e-8
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.ones_like(x), torch.sin(safe) / safe)


def _mod_cosine(theta):
    """Gautschi mod-cosine filter: cos(th/2)^2 * sinc(th), guarded at 1e-12."""
    small = torch.abs(theta) < 1e-12
    safe = torch.where(small, torch.ones_like(theta), theta)
    val = torch.cos(safe / 2.0) ** 2 * torch.sin(safe) / safe
    return torch.where(small, torch.ones_like(theta), val)


def _phi1(x):
    """phi_1(x) = (exp(x) - 1)/x, -> 1 at 0."""
    small = torch.abs(x) < 1e-8
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.ones_like(x),
                       (torch.exp(safe) - 1.0) / safe)


MATFUNCS = {
    "exp": lambda t, lam: torch.exp(t * lam),
    "sinc": lambda t, lam: _sinc(t * lam),
    "phi1": lambda t, lam: _phi1(t * lam),
    "cos_sqrt": lambda t, lam: torch.cos(t * torch.sqrt(torch.abs(lam))),
    "sinc2_sqrt": lambda t, lam: _sinc(t * torch.sqrt(torch.abs(lam))) ** 2,
    "id_sqrt": lambda t, lam: t * torch.sqrt(torch.abs(lam)),
    "sinc2_sqrt_half":
        lambda t, lam: _sinc(t / 2.0 * torch.sqrt(torch.abs(lam))) ** 2,
    "mod_cosine":
        lambda t, lam: _mod_cosine(t * torch.sqrt(torch.abs(lam))) ** 2,
}


def _python_scalar(t):
    """A time step as a Python number: complex when it has an imaginary
    part (SS2's tau = i dt), float otherwise, so that it takes the precision
    of the tensor it multiplies, as a numpy scalar does in the JAX package."""
    t = np.asarray(t)
    return complex(t) if np.iscomplexobj(t) else float(t)


def lanczos(matvec, u, m, reorth=True):
    """m-step (Hermitian) Lanczos of a matrix-free operator.

    Returns V: (m,) + u.shape basis, alpha: (m,) real diagonal of T,
    beta: (m-1,) real off-diagonal, beta0: real norm of u.
    """
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth)
    V = torch.stack(vs)
    alpha, beta = tridiag_entries(alphas, betas, beta0, m,
                                  real_dtype_of(u.dtype))
    return V, alpha, beta, beta0


def tridiag_entries(alphas, betas, beta0, m, rdtype):
    """alpha (m,) and beta (m-1,) of T from the per-iteration scalars."""
    # alpha[m-1] stays 0: the reference's loop never writes T(m-1, m-1)
    # (eigen_krylov_real.hpp:14,23-49), and f(T) sees that 0.
    zero = torch.zeros((), dtype=rdtype, device=beta0.device)
    alpha = torch.stack(alphas + [zero])
    beta = (torch.stack(betas) if betas
            else torch.zeros((0,), dtype=rdtype, device=beta0.device))
    return alpha, beta


def _lanczos_cols(matvec, u, m, reorth=True):
    """Lanczos keeping the basis as a list of columns."""
    rdtype = real_dtype_of(u.dtype)

    def gnorm(x):
        sq = x.real ** 2 + x.imag ** 2 if x.is_complex() else x ** 2
        return torch.sqrt(torch.sum(sq)).to(rdtype)

    # A zero start vector or an exact breakdown yields ZERO columns instead
    # of NaN; bit-identical to the raw division whenever the norm is > 0.
    def safe_div(x, nrm):
        return (x / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(
            u.dtype)

    beta0 = gnorm(u)
    vs = [safe_div(u, beta0)]
    n = u.numel()
    alphas, betas = [], []
    for j in range(m - 1):
        vj = vs[j]
        w = matvec(vj).to(u.dtype)
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        if reorth:
            # one classical Gram-Schmidt pass against every column: alpha is
            # the last projection (the Rayleigh quotient v_j . w)
            Vm = torch.stack([v.reshape(n) for v in vs])      # (j+1, n)
            proj = torch.matmul(Vm.conj(), w.reshape(n))       # (j+1,)
            a = proj[j].real.to(rdtype)
            w = w - torch.matmul(proj, Vm).reshape(u.shape)
        else:
            a = torch.sum(vj.conj() * w).real.to(rdtype)
            w = w - a * vj
        b = gnorm(w)
        vs.append(safe_div(w, b))
        alphas.append(a)
        betas.append(b)
    return vs, alphas, betas, beta0


def tridiag_eigh(alpha, beta):
    """Eigendecomposition of the real symmetric tridiagonal T(alpha, beta).

    On a CUDA device torch.linalg.eigh runs in cuSOLVER; PERF.md records
    whether it waits for the host.
    """
    T = torch.diag(alpha) + torch.diag(beta, 1) + torch.diag(beta, -1)
    return torch.linalg.eigh(T)


def coefficients(func, t, lam, Q, beta0):
    """beta0 * Q f(t, lam) Q^T e1: the weights of the basis columns. `func`
    is a MATFUNCS key or a callable (t, lam) -> values.

    Written as an elementwise product and a sum, so it runs in the full
    precision of Q on every device (no TF32 path)."""
    f = MATFUNCS[func] if isinstance(func, str) else func
    fvals = f(_python_scalar(t), lam)
    return beta0 * torch.sum(Q * (fvals * Q[0, :]), dim=-1)


def matfunc_apply(matvec, u, t, func, m=default_krylov_m, reorth=True):
    """y = beta0 * V (Q f(t, D) Q^T e1): one matrix function of the operator
    applied to u. `t` may be complex (tau = i dt in SS2)."""
    return matfunc_apply_multi(matvec, u, ((t, func),), m=m, reorth=reorth)[0]


def matfunc_apply_multi(matvec, u, specs, m=default_krylov_m, reorth=True):
    """[f(t L) u for (t, f) in specs] from ONE Lanczos decomposition of u."""
    specs = tuple(specs)
    fused = _fused_path(matvec, u, specs, m, reorth)
    if fused is not None:
        return fused
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth)
    alpha, beta = tridiag_entries(alphas, betas, beta0, m,
                                  real_dtype_of(u.dtype))
    lam, Q = tridiag_eigh(alpha, beta)
    outs = []
    for t, func in specs:
        coef = coefficients(func, t, lam, Q, beta0).to(u.dtype)
        out = coef[0] * vs[0]
        for i in range(1, m):
            out = out + coef[i] * vs[i]
        outs.append(out.to(u.dtype))
    return tuple(outs)


def _fused_path(matvec, u, specs, m, reorth):
    """Dispatch to the fused Lanczos kernels (ops/cuda/) when the
    operator carries a descriptor and the configuration allows it. Returns
    None when the generic path should run instead. The fused path always
    reorthogonalizes fully, so reorth=False falls through."""
    desc = getattr(matvec, "kernel_desc", None)
    if desc is None or not reorth or u.ndim not in (2, 3):
        return None
    if config.kernel_mode == "off":
        return None
    from nlsolvers_tpu_torch.ops.cuda.lanczos2d import (
        matfunc_apply_planar_multi, supported_desc)
    if not supported_desc(desc, u.shape, u.dtype):
        return None
    # 3D fields run on the merged (nz*ny, nx) row view
    view = (u.shape[0] * u.shape[1], u.shape[2]) if u.ndim == 3 else u.shape
    if u.dtype == torch.complex64:
        planar = torch.stack([u.real.reshape(view), u.imag.reshape(view)])
        outs = matfunc_apply_planar_multi(planar, desc, specs, m)
        return tuple(torch.complex(o[0], o[1]).reshape(u.shape)
                     for o in outs)
    outs = matfunc_apply_planar_multi(u.reshape(view)[None].contiguous(),
                                      desc, specs, m)
    return tuple(o[0].reshape(u.shape) for o in outs)


def expm_apply(matvec, u, t, m=default_krylov_m, reorth=True):
    """exp(t L) u: the reference's `expm_multiply`
    (eigen_krylov_complex.hpp:54-83)."""
    return matfunc_apply(matvec, u, t, "exp", m=m, reorth=reorth)
