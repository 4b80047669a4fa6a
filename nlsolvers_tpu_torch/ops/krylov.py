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
`_fused_path`. Every function takes `mesh`, the counterpart of the JAX
package's `axis_names`: u is then a sharded field (parallel/shards.py) and
the reductions are sums over its shards, the generic sharded path of the
complex128 and reorth=False steps (parallel/spatial.py).
"""

import numpy as np
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.config import default_krylov_m, real_dtype_of
from nlsolvers_tpu_torch.parallel import shards

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


def lanczos(matvec, u, m, reorth=True, mesh=None):
    """m-step (Hermitian) Lanczos of a matrix-free operator.

    Returns V: (m,) + u.shape basis, alpha: (m,) real diagonal of T,
    beta: (m-1,) real off-diagonal, beta0: real norm of u. With `mesh` (the
    JAX package's axis_names), u is a sharded field and V one (m,) + block
    stack per shard; T and beta0 are the first shard's copies.
    """
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth,
                                             mesh=mesh)
    rdtype = real_dtype_of(beta0[0].dtype)
    alpha, beta = tridiag_entries([a[0] for a in alphas],
                                  [b[0] for b in betas], beta0[0], m, rdtype)
    V = [torch.stack([v[k] for v in vs]) for k in range(len(beta0))]
    return (V[0] if mesh is None else V), alpha, beta, beta0[0]


def tridiag_entries(alphas, betas, beta0, m, rdtype):
    """alpha (m,) and beta (m-1,) of T from the per-iteration scalars; for a
    batch of lanes (scalars of shape (B,)) alpha (B, m) and beta (B, m-1)."""
    # alpha[m-1] stays 0: the reference's loop never writes T(m-1, m-1)
    # (eigen_krylov_real.hpp:14,23-49), and f(T) sees that 0.
    zero = torch.zeros(beta0.shape, dtype=rdtype, device=beta0.device)
    alpha = torch.stack(alphas + [zero], dim=-1)
    beta = (torch.stack(betas, dim=-1) if betas
            else torch.zeros(beta0.shape + (0,), dtype=rdtype,
                             device=beta0.device))
    return alpha, beta


def _lanczos_cols(matvec, u, m, reorth=True, mesh=None):
    """Lanczos keeping the basis as a list of columns, each column a list
    of per-shard blocks and each scalar a list of per-shard copies.

    Without a mesh u is one tensor, the one shard of this arithmetic. With
    `mesh`, u is a sharded field (parallel/shards.py), matvec maps a sharded
    field to one, and every dot and norm is each shard's partial summed over
    the shards in shard order (shards.psum: JAX's psum over axis_names), so
    every shard holds the same scalars."""
    parts = [u] if mesh is None else list(u)
    apply = (lambda ps: [matvec(ps[0])]) if mesh is None else matvec
    dtype = parts[0].dtype
    rdtype = real_dtype_of(dtype)

    def gsum(xs):
        return xs if mesh is None else shards.psum(xs, mesh)

    def gnorm(xs):
        sq = [x.real ** 2 + x.imag ** 2 if x.is_complex() else x ** 2
              for x in xs]
        return [torch.sqrt(s).to(rdtype)
                for s in gsum([torch.sum(q) for q in sq])]

    # A zero start vector or an exact breakdown yields ZERO columns instead
    # of NaN; bit-identical to the raw division whenever the norm is > 0.
    def safe_div(xs, nrms):
        return [(x / torch.where(n > 0, n, torch.ones_like(n))).to(dtype)
                for x, n in zip(xs, nrms)]

    beta0 = gnorm(parts)
    vs = [safe_div(parts, beta0)]
    alphas, betas = [], []
    for j in range(m - 1):
        vj = vs[j]
        w = [x.to(dtype) for x in apply(vj)]
        if j > 0:
            w = [x - b * v for x, b, v in zip(w, betas[j - 1], vs[j - 1])]
        if reorth:
            # one classical Gram-Schmidt pass against every column: alpha is
            # the last projection (the Rayleigh quotient v_j . w)
            Vm = [torch.stack([v[k].reshape(-1) for v in vs])  # (j+1, n)
                  for k in range(len(parts))]
            proj = gsum([torch.matmul(V.conj(), x.reshape(-1))
                         for V, x in zip(Vm, w)])             # (j+1,)
            a = [p[j].real.to(rdtype) for p in proj]
            w = [x - torch.matmul(p, V).reshape(x.shape)
                 for x, p, V in zip(w, proj, Vm)]
        else:
            a = [s.real.to(rdtype) for s in gsum(
                [torch.sum(v.conj() * x) for v, x in zip(vj, w)])]
            w = [x - ak * v for x, ak, v in zip(w, a, vj)]
        b = gnorm(w)
        vs.append(safe_div(w, b))
        alphas.append(a)
        betas.append(b)
    return vs, alphas, betas, beta0


def tridiag_eigh(alpha, beta):
    """Eigendecomposition of the real symmetric tridiagonal T(alpha, beta).

    On a CUDA device torch.linalg.eigh runs in cuSOLVER; PERF.md records
    whether it waits for the host.

    A batch (alpha (B, m), beta (B, m-1)) is one batched eigh, as JAX's
    vmapped eigh. torch raises where a lane's T is not finite, and JAX
    gives that lane NaN: such a T is replaced by the identity before the
    eigh (torch.where, no host branch) and its eigenvalues set to NaN
    after, so its coefficients are NaN and the other lanes are untouched.
    """
    T = (torch.diag_embed(alpha) + torch.diag_embed(beta, 1)
         + torch.diag_embed(beta, -1))
    if T.dim() == 2:
        return torch.linalg.eigh(T)
    ok = torch.isfinite(T).all(dim=-1).all(dim=-1)
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    lam, Q = torch.linalg.eigh(torch.where(ok[..., None, None], T, eye))
    return torch.where(ok[..., None], lam, float("nan")), Q


def coefficients(func, t, lam, Q, beta0):
    """beta0 * Q f(t, lam) Q^T e1: the weights of the basis columns. `func`
    is a MATFUNCS key or a callable (t, lam) -> values. A batch carries a
    leading B on lam, Q and beta0.

    Written as an elementwise product and a sum, so it runs in the full
    precision of Q on every device (no TF32 path)."""
    f = MATFUNCS[func] if isinstance(func, str) else func
    fvals = f(_python_scalar(t), lam)
    return beta0[..., None] * torch.sum(
        Q * (fvals * Q[..., 0, :])[..., None, :], dim=-1)


def matfunc_apply(matvec, u, t, func, m=default_krylov_m, reorth=True,
                  mesh=None):
    """y = beta0 * V (Q f(t, D) Q^T e1): one matrix function of the operator
    applied to u. `t` may be complex (tau = i dt in SS2). With `mesh`, u and
    y are sharded fields (_lanczos_cols)."""
    return matfunc_apply_multi(matvec, u, ((t, func),), m=m, reorth=reorth,
                               mesh=mesh)[0]


def matfunc_apply_multi(matvec, u, specs, m=default_krylov_m, reorth=True,
                        mesh=None):
    """[f(t L) u for (t, f) in specs] from ONE Lanczos decomposition of u.

    With `mesh` (the JAX package's axis_names: krylov.py:94-140, 221-252),
    u and each output are sharded fields and the Lanczos reductions are
    sums over the shards in shard order; tridiag_eigh runs once on the
    reduced T, which every shard holds, as JAX's replicated eigh, and each
    shard combines its own columns with those coefficients. The sharded
    form is the generic path only: the shard kernels take planar state
    through parallel/lanczos.py."""
    specs = tuple(specs)
    if mesh is None:
        fused = _fused_path(matvec, u, specs, m, reorth)
        if fused is not None:
            return fused
    vs, alphas, betas, beta0 = _lanczos_cols(matvec, u, m, reorth=reorth,
                                             mesh=mesh)
    dtype = vs[0][0].dtype
    alpha, beta = tridiag_entries([a[0] for a in alphas],
                                  [b[0] for b in betas], beta0[0], m,
                                  real_dtype_of(dtype))
    lam, Q = tridiag_eigh(alpha, beta)
    outs = []
    for t, func in specs:
        coef = coefficients(func, t, lam, Q, beta0[0]).to(dtype)
        coefs = [coef] if mesh is None else shards.broadcast(coef, mesh)
        out = []
        for k, ck in enumerate(coefs):
            y = ck[0] * vs[0][k]
            for i in range(1, m):
                y = y + ck[i] * vs[i][k]
            out.append(y.to(dtype))
        outs.append(out[0] if mesh is None else out)
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


def expm_apply(matvec, u, t, m=default_krylov_m, reorth=True, mesh=None):
    """exp(t L) u: the reference's `expm_multiply`
    (eigen_krylov_complex.hpp:54-83)."""
    return matfunc_apply(matvec, u, t, "exp", m=m, reorth=reorth, mesh=mesh)
