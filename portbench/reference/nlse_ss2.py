"""Plain reference of the NLSE datagen step: SS2 with Lanczos, in PyTorch.

The configuration's own numerics, written again from the reference solver's
description and independent of the program under test (it imports nothing
of it, and takes only the inputs the benchmark hands out):

  i u_t = -div(c grad u) - m |u|^2 u on a no-flux grid, one Strang step
  u <- K(dt/2) u;  u <- exp(i dt L) u;  u <- G K(dt/2) u

  K(theta) u   = u exp(i theta m |u|^2)                  (the half kick)
  L            = div(c grad .) / dx^2, finite volume: face weight = mean of
                 the two cells' c, no flux through the domain's faces; in 3D
                 the y faces couple consecutive rows of the merged
                 (nz*ny, nx) view, the y-seam of the reference's
                 build_anisotropic_laplacian_noflux_3d (laplacians.hpp:158-218)
  exp(i dt L) u  m-step Lanczos with one classical Gram-Schmidt pass
                 against every column, T with alpha[m-1] = 0 (the reference
                 loop never writes it, eigen_krylov_real.hpp:14,23-49),
                 beta0 V Q exp(i dt Lambda) Q^T e1
  G            = the no-flux ghost copy: 2D edge rows over interior
                 columns, then full edge columns (boundaries.hpp:41-57);
                 3D x faces over interior (y, z), y faces over interior z,
                 then z faces (boundaries_3d.hpp:8-31)

Snapshot 0 is the initial condition, snapshot s the state after s * freq
steps. The lanes of a batch are independent trajectories, held as one
(B, *shape) tensor so that a block of lanes shares each launch.

`precision="float64"` is the reference. `precision="tf32"` is the control:
the same arithmetic in complex64, with every product of the Krylov basis
(the projections, the Gram-Schmidt update and the combine) taken on
operands rounded to TF32's 10-bit mantissa, as a tensor-core matrix
product rounds them, and accumulated in float32. `precision="float32"` is
the same arithmetic in plain complex64: a second float32 implementation,
the witness of what float32 rounding alone does to a lane.
"""

import torch

__all__ = ["trajectory", "operator", "tf32_round"]


def tf32_round(x):
    """x (float32 or complex64) with each float rounded to nearest even at
    TF32's 10 mantissa bits."""
    if x.is_complex():
        return torch.complex(tf32_round(x.real.contiguous()),
                             tf32_round(x.imag.contiguous()))
    bits = x.view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


def _faces(c, axis):
    n = c.shape[axis]
    return 0.5 * (c.narrow(axis, 0, n - 1) + c.narrow(axis, 1, n - 1))


def _flux(out, u, w, axis):
    """out += div of the flux w * (u[i+1] - u[i]) along `axis`."""
    n = u.shape[axis]
    f = w * (u.narrow(axis, 1, n - 1) - u.narrow(axis, 0, n - 1))
    out.narrow(axis, 0, n - 1).add_(f)
    out.narrow(axis, 1, n - 1).sub_(f)


def operator(c, dx):
    """L u = div(c grad u) / dx^2 for a batch of c fields (B, *shape)."""
    dim = c.dim() - 1
    scale = 1.0 / (dx * dx)
    if dim == 2:
        wx, wy = _faces(c, -1), _faces(c, -2)

        def apply(u):
            out = torch.zeros_like(u)
            _flux(out, u, wx, -1)
            _flux(out, u, wy, -2)
            return out * scale
        return apply
    B, nz, ny, nx = c.shape
    wx, wz = _faces(c, -1), _faces(c, -3)
    wy = _faces(c.reshape(B, nz * ny, nx), -2)

    def apply(u):
        out = torch.zeros_like(u)
        _flux(out, u, wx, -1)
        _flux(out, u, wz, -3)
        _flux(out.view(B, nz * ny, nx), u.reshape(B, nz * ny, nx), wy, -2)
        return out * scale
    return apply


def _ghost(u):
    """The no-flux ghost copy, in place."""
    if u.dim() == 3:
        u[:, 0, 1:-1] = u[:, 1, 1:-1]
        u[:, -1, 1:-1] = u[:, -2, 1:-1]
        u[:, :, 0] = u[:, :, 1]
        u[:, :, -1] = u[:, :, -2]
        return u
    u[:, 1:-1, 1:-1, 0] = u[:, 1:-1, 1:-1, 1]
    u[:, 1:-1, 1:-1, -1] = u[:, 1:-1, 1:-1, -2]
    u[:, 1:-1, 0, :] = u[:, 1:-1, 1, :]
    u[:, 1:-1, -1, :] = u[:, 1:-1, -2, :]
    u[:, 0] = u[:, 1]
    u[:, -1] = u[:, -2]
    return u


def _kick(u, m, theta):
    rho = m * (u.real * u.real + u.imag * u.imag)
    return u * torch.exp(1j * theta * rho)


def _expm(apply, u, t, krylov_m, rnd):
    """exp(t L) u per lane by Lanczos (module docstring). The basis is
    held lane-major, (B, m, n), so that every product is a batched matrix
    product over the lanes."""
    B = u.shape[0]
    rdt = u.real.dtype
    V = torch.empty((B, krylov_m, u[0].numel()), dtype=u.dtype,
                    device=u.device)

    def norm(x):
        return torch.sqrt(torch.sum(x.real * x.real + x.imag * x.imag,
                                    dim=-1))

    def unit(x, n):
        return x / torch.where(n > 0, n, torch.ones_like(n))[:, None]

    beta0 = norm(u.reshape(B, -1))
    V[:, 0] = unit(u.reshape(B, -1), beta0)
    alphas, betas = [], []
    for j in range(krylov_m - 1):
        w = apply(V[:, j].view(u.shape)).reshape(B, -1)
        if j > 0:
            w = w - betas[-1][:, None] * V[:, j - 1]
        Vj = rnd(V[:, :j + 1])
        # <v_k, w> = conj(sum conj(w) v_k)
        proj = torch.matmul(rnd(w).conj()[:, None, :],
                            Vj.transpose(1, 2)).conj()      # (B, 1, j+1)
        alphas.append(proj[:, 0, j].real)
        w = w - torch.matmul(rnd(proj), Vj)[:, 0]
        b = norm(w)
        betas.append(b)
        V[:, j + 1] = unit(w, b)
    alpha = torch.stack(alphas + [torch.zeros_like(beta0)], dim=-1)
    T = torch.diag_embed(alpha)
    if betas:
        beta = torch.stack(betas, dim=-1)
        T = T + torch.diag_embed(beta, 1) + torch.diag_embed(beta, -1)
    lam, Q = torch.linalg.eigh(T.to(rdt))
    coef = beta0[:, None] * torch.einsum(
        "bik,bk->bi", Q.to(u.dtype), torch.exp(t * lam) * Q[:, 0, :])
    y = torch.matmul(rnd(coef.to(u.dtype))[:, None, :], rnd(V))[:, 0]
    return y.view(u.shape)


def trajectory(u0, m, c, *, Lx, dt, krylov_m, num_snapshots, snapshot_freq,
               emit, precision="float64"):
    """Evolve lanes (u0 (B, 2, *shape) packed re/im, m and c (B, *shape))
    and call emit(s, u) with each snapshot s, u complex (B, *shape)."""
    if precision not in ("float64", "float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    exact = precision == "float64"
    cdt = torch.complex128 if exact else torch.complex64
    rdt = torch.float64 if exact else torch.float32
    rnd = tf32_round if precision == "tf32" else (lambda x: x)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        nx = u0.shape[-1]
        dx = 2.0 * Lx / (nx - 1)
        u = torch.complex(u0[:, 0].to(rdt), u0[:, 1].to(rdt)).to(cdt)
        m = m.to(rdt)
        apply = operator(c.to(rdt), dx)
        emit(0, u)
        for s in range(1, num_snapshots):
            for _ in range(snapshot_freq):
                u = _kick(u, m, 0.5 * dt)
                u = _expm(apply, u, 1j * dt, krylov_m, rnd)
                u = _ghost(_kick(u, m, 0.5 * dt))
            emit(s, u)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return u
