"""Plain reference of the real-wave datagen step: Gautschi with Lanczos, in
PyTorch.

The configuration's own numerics, written again from the reference
solvers' equations (SURVEY.md section 2.3) and independent of the program
under test (it imports nothing of it, and takes only the inputs the
benchmark hands out):

  u_tt = div(c grad u) - m g(u) on a no-flux grid, one two-step Gautschi
  step (sg_single_solver.hpp:42-59, kg_solver.hpp:10-24):

  u' = 2 cos(tau W) u - u_past + tau^2 sinc^2(tau W / 2) (-m g(F u))

  W = sqrt(|L|)   L = div(c grad .) / dx^2, the finite volume of
                  nlse_ss2.operator (face weight = mean of the two cells'
                  c, no flux through the domain's faces)
  F               the filter: mod_cosine, (cos^2(theta/2) sinc(theta))^2
                  of theta = tau W, for single sine-Gordon
                  (sg_single_solver.hpp:52); id_sqrt, theta itself, for
                  the other kinds
  g               sin (sine_gordon); sin u + sin(u/2) (double_sine_gordon,
                  sg_double_solver.hpp:8-25 as SURVEY.md reads it); sinh
                  (hyperbolic_sine_gordon); u^3 (klein_gordon: the code's
                  -m u^3, kg_solver.hpp:17, not its comment's m u); u - u^3
                  (phi4)
  f(tau W) x      m-step Lanczos of L from x, one classical Gram-Schmidt
                  pass against every column, T with alpha[m-1] = 0 (the
                  reference loop never writes it, eigen_krylov_real.hpp:
                  14,23-49), beta0 V Q f(tau sqrt|Lambda|) Q^T e1: cos and
                  F from u's basis, sinc^2(theta/2) from the force's
  then the no-flux ghost copy of u' (nlse_ss2's: edge rows over interior
  columns, then full edge columns; in 3D the x, y, z faces)

The state. The two-step state (u, u_past) starts from an input (u0, v0) as
u_past = u0 - tau v0, and a snapshot is (u, v) with v = (u - u_past) / tau:
the engine's own definitions (pipeline/engine.py,
make_realwave_trajectory_fn: `setup` and `observe`; v is the reference
driver's finite-difference velocity, kg_driver.cpp:112). So the program's
snapshot s-1 (u, v) starts an interval exactly as an input does (`start`):
u_past = u - tau v. Snapshot 0 holds u0 bit for bit; its v is
(u0 - u_past) / tau in float32, within rounding of v0 and not equal to it,
so EXACT_START is u.

The check compares u (FIELDS). A float32 program knows v only to about
eps ||u|| / (tau ||v||): at 24^2 with tau = 6e-4 the port's v reads
0.04-0.11 from the float64 reference relative to its own norm, a second
float32 implementation (precision "float32") as much, where u reads
1e-5. A limit on v's gap would sit near 1, and a step that returns its
state unchanged (v's gap ~0.1) would pass it. v is checked through the
next interval instead: its start rebuilds u_past = u - tau v from the
program's v, so a v that is off moves that interval's u.

Snapshot 0 is the input, snapshot s the state after s * freq steps. The
lanes of a batch are independent trajectories, held as one (B, *shape)
tensor so that a block of lanes shares each launch.

`precision="float64"` is the reference. `precision="tf32"` is the control:
the same arithmetic in float32, with every product of the Krylov basis (the
projections, the Gram-Schmidt update and the combine) taken on operands
rounded to TF32's 10-bit mantissa, as a tensor-core matrix product rounds
them, and accumulated in float32. `precision="float32"` is the same
arithmetic in plain float32: a second float32 implementation.
"""

import torch

from portbench.reference.nlse_ss2 import _ghost, operator, tf32_round

__all__ = ["FIELDS", "EXACT_START", "start", "from_program", "trajectory"]

FIELDS = ("u",)
EXACT_START = ("u",)


def start(snapshot):
    """The state an interval starts from: the program's snapshot s-1
    ({field: (B, *shape) tensor}) as an input (u0, v0)."""
    return snapshot["u"], snapshot["v"]


def from_program(fields):
    """The program's FIELDS (float64 tensors) as trajectory emits them."""
    return tuple(fields)


def _sinc(x):
    zero = x == 0
    safe = torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.ones_like(x), torch.sin(safe) / safe)


def _mod_cosine(theta):
    return (torch.cos(theta / 2) ** 2 * _sinc(theta)) ** 2


def _sinc2_half(theta):
    return _sinc(theta / 2) ** 2


FORCES = {
    "sine_gordon": torch.sin,
    "double_sine_gordon": lambda u: torch.sin(u) + torch.sin(0.5 * u),
    "hyperbolic_sine_gordon": torch.sinh,
    "klein_gordon": lambda u: u ** 3,
    "phi4": lambda u: u - u ** 3,
}


def _matfuncs(apply, x, funcs, tau, krylov_m, rnd):
    """[f(tau W) x for f in funcs] per lane, each f a function of theta =
    tau sqrt|lambda|, from one Lanczos run of x. The basis is held
    lane-major, (B, m, n), so that every product is a batched matrix
    product over the lanes."""
    B = x.shape[0]
    V = torch.empty((B, krylov_m, x[0].numel()), dtype=x.dtype,
                    device=x.device)

    def norm(y):
        return torch.sqrt(torch.sum(y * y, dim=-1))

    def unit(y, n):
        return y / torch.where(n > 0, n, torch.ones_like(n))[:, None]

    beta0 = norm(x.reshape(B, -1))
    V[:, 0] = unit(x.reshape(B, -1), beta0)
    alphas, betas = [], []
    for j in range(krylov_m - 1):
        w = apply(V[:, j].view(x.shape)).reshape(B, -1)
        if j > 0:
            w = w - betas[-1][:, None] * V[:, j - 1]
        Vj = rnd(V[:, :j + 1])
        proj = torch.matmul(rnd(w)[:, None, :], Vj.transpose(1, 2))
        alphas.append(proj[:, 0, j])
        w = w - torch.matmul(rnd(proj), Vj)[:, 0]
        b = norm(w)
        betas.append(b)
        V[:, j + 1] = unit(w, b)
    alpha = torch.stack(alphas + [torch.zeros_like(beta0)], dim=-1)
    T = torch.diag_embed(alpha)
    if betas:
        beta = torch.stack(betas, dim=-1)
        T = T + torch.diag_embed(beta, 1) + torch.diag_embed(beta, -1)
    lam, Q = torch.linalg.eigh(T)
    theta = tau * torch.sqrt(torch.abs(lam))
    out = []
    for f in funcs:
        coef = beta0[:, None] * torch.einsum("bik,bk->bi", Q,
                                             f(theta) * Q[:, 0, :])
        out.append(torch.matmul(rnd(coef)[:, None, :], rnd(V))[:, 0]
                   .view(x.shape))
    return out


def trajectory(u0, v0, m, c, *, system, Lx, dt, krylov_m, num_snapshots,
               snapshot_freq, emit, precision="float64"):
    """Evolve lanes (u0, v0, m and c (B, *shape)) of the real-wave `system`
    and call emit(s, u) with each snapshot s (FIELDS: the velocity is
    checked through the next interval's start, module docstring)."""
    if precision not in ("float64", "float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if system not in FORCES:
        raise ValueError(f"no Gautschi reference for {system!r}")
    rdt = torch.float64 if precision == "float64" else torch.float32
    rnd = tf32_round if precision == "tf32" else (lambda x: x)
    g = FORCES[system]
    filt = _mod_cosine if system == "sine_gordon" else (lambda th: th)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        nx = u0.shape[-1]
        dx = 2.0 * Lx / (nx - 1)
        apply = operator(c.to(rdt), dx)
        m = m.to(rdt)
        u = u0.to(rdt)
        u_past = u - dt * v0.to(rdt)
        emit(0, u)
        for s in range(1, num_snapshots):
            for _ in range(snapshot_freq):
                fu, cu = _matfuncs(apply, u, (filt, torch.cos), dt,
                                   krylov_m, rnd)
                force = -(m * g(fu))
                s2, = _matfuncs(apply, force, (_sinc2_half,), dt, krylov_m,
                                rnd)
                u, u_past = _ghost(2.0 * cu - u_past + (dt * dt) * s2), u
            emit(s, u)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return u
