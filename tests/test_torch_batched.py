"""The batched 2D SS2 datagen step of the port on the CPU.

A batch is B planar fields (B, P, ny, nx) stepped together, the form that
jax.vmap gives the JAX package's datagen engine: each kernel (K1/K1',
K2/K2', K3, kick_bc) takes the lanes in one launch, the scalar recurrence
runs on (B, ...) tensors and the eigh is one batched call. On the CPU the
wrappers take the kernels' plain versions, vectorised over the lanes.

* Each batched plain version equals the unbatched one lane by lane, bit for
  bit, at B = 3 on seeded numpy inputs: K1/K1' (with the norm of W_j),
  K2/K2' (the last iteration too), K3 (k = 1, 2) and kick_bc with and
  without the ghost copy; the batched eigh gives each finite lane the
  single-matrix eigh's bits and a non-finite lane NaN eigenvalues.
* The batched SS2 step (models/nlse.ss2_step_planar on a (B, 2, ny, nx)
  state) against nlse_problem run alone on each lane after 10 steps, iso
  and c(x): rel-L2 <= 1e-6 (printed).
* The batched engine (pipeline/engine.make_nlse_trajectory_fn, complex64
  planar SS2) against JAX's vmapped engine with its Pallas kernels in
  interpret mode, as tests/test_pallas.py:731-756 runs it, at 32 x 128
  (JAX's Pallas gate needs nx % 128 == 0), B = 3, c(x) and iso: the
  initial snapshot equal, the last within rel-L2 1e-5 per lane, the gate of
  tests/test_torch_datagen.py's test_nlse_engine_planar_c_matches_jax_
  interpret.
* A lane started as NaN: its snapshots are NaN, bad_at flags it at
  snapshot 0, the mass series is NaN on it, and the other lanes equal their
  runs alone; evolve_guarded carries the tensor state.
* A batch with the fused iteration runs one K5 call per iteration, a 3D
  batch with the 3D pipe one K8 call per iteration but the last, a 3D
  batch with neither the two-pass loop (tests/test_torch_batched3d.py;
  the batched K5 and K8: tests/test_torch_batched_optin.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.models import nlse, problems
from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
from nlsolvers_tpu_torch.ops import krylov
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import kick as tk
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.pipeline import engine as teng
from test_torch_datagen import _jax_planar, jax_interpret  # noqa: F401

torch.set_num_threads(1)

B, LX, DT = 3, 5.0, 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _descs(op, shape, seed):
    """(batched descriptor, the lanes' own descriptors) of the iso or c(x)
    operator on `shape`."""
    ny, nx = shape
    if op == "iso":
        d = tops.laplacian_2d(shape, 0.1, 0.1, device="cpu").kernel_desc
        return d, [d] * B
    c = 1.0 + 0.4 * np.random.default_rng(seed).random((B, ny, nx))
    lanes = [tops.anisotropic_laplacian_2d(c[b], 0.1, 0.1,
                                           device="cpu").kernel_desc
             for b in range(B)]
    return tops.batched_aniso_laplacian_2d(list(c), 0.1, 0.1,
                                           device="cpu"), lanes


def _lanes_equal(got, want_of):
    for b in range(B):
        for x, y in zip(got, want_of(b)):
            assert torch.equal(x[b], y)


@pytest.mark.parametrize("op", ["iso", "aniso"])
@pytest.mark.parametrize("P,shape", [(2, (16, 32)), (1, (13, 21)),
                                     (2, (9, 7))])
def test_plain_kernels_batched_equal_lanes(op, P, shape):
    """K1/K1', K2/K2' (last too) and K3 plain versions on (B, P, ny, nx)
    equal the unbatched ones on each lane, bit for bit."""
    rng = np.random.default_rng(40 + P)
    desc, lanes = _descs(op, shape, 41)
    cols = [_t(rng.standard_normal((B, P) + shape)) for _ in range(8)]
    p1 = tl.pass1_iso2d if op == "iso" else tl.pass1_aniso2d
    pp = tl.pipe_iso2d if op == "iso" else tl.pipe_aniso2d
    for j in (0, 4):
        scal = _t(rng.uniform(-1, 1, (B, 1, 2)))
        _lanes_equal(p1(scal, cols[j], cols[:j], desc, norm=True),
                     lambda b: p1(scal[b], cols[j][b],
                                  [w[b] for w in cols[:j]], lanes[b],
                                  norm=True))
    for j, last in ((0, False), (3, False), (5, True)):
        scal = _t(rng.uniform(-0.5, 0.5, (B, j + 2, 2)))
        _lanes_equal(pp(scal, cols[7], cols[:j + 1], desc, last),
                     lambda b: pp(scal[b], cols[7][b],
                                  [w[b] for w in cols[:j + 1]], lanes[b],
                                  last))
    for k in (1, 2):
        q = _t(rng.uniform(-0.5, 0.5, (B, k, 6, 2)))
        _lanes_equal(tl.combine(q, cols[:6]),
                     lambda b: tl.combine(q[b], [w[b] for w in cols[:6]]))


def test_plain_pass1_norm_is_the_columns_norm():
    """The norm K1 returns beside (w, raw) is ||W_j||^2 per lane."""
    rng = np.random.default_rng(44)
    desc, _ = _descs("iso", (12, 20), 45)
    u = _t(rng.standard_normal((B, 2, 12, 20)))
    w, raw, nsq = tl.pass1_iso2d(torch.eye(1, 2).expand(B, 1, 2), u, [],
                                 desc, norm=True)
    assert nsq.shape == (B,)
    torch.testing.assert_close(nsq, (u * u).sum(dim=(1, 2, 3)))
    w1, raw1 = tl.pass1_iso2d(torch.eye(1, 2), u[0], [], desc)
    assert torch.equal(w[0], w1) and torch.equal(raw[0], raw1)


@pytest.mark.parametrize("kind", ["cubic", "cubic_quintic", "saturable"])
@pytest.mark.parametrize("shape", [(16, 32), (9, 7)])
def test_plain_kick_bc_batched_equals_lanes(kind, shape):
    """kick_bc_ref on a (B, 2, ny, nx) batch with per-lane m fields, with
    and without the ghost copy, equals each lane's unbatched call."""
    rng = np.random.default_rng(50)
    up = _t(rng.standard_normal((B, 2) + shape))
    m = _t(0.5 + rng.random((B,) + shape))
    rho = nlse_density_planar(kind, m, sigma1=0.8, sigma2=-0.15, kappa=0.7)
    for grid in (None, tk.kick_grid(shape)):
        got = tk.phase_kick_bc_planar(up, rho, 0.3, grid)
        assert got.shape == up.shape
        for b in range(B):
            lane = nlse_density_planar(kind, m[b], sigma1=0.8, sigma2=-0.15,
                                       kappa=0.7)
            assert torch.equal(got[b], tk.phase_kick_bc_planar(
                up[b], lane, 0.3, grid))


def test_batched_eigh_lanes_and_nan_lane():
    """One batched eigh: each finite lane the single-matrix eigh's bits; a
    lane with a non-finite T gets NaN eigenvalues (JAX's vmapped eigh gives
    NaN where torch raises) and leaves the others untouched."""
    rng = np.random.default_rng(60)
    alpha = torch.from_numpy(rng.standard_normal((B, 8)))
    beta = torch.from_numpy(rng.random((B, 7)))
    alpha[1, 3] = float("nan")
    lam, Q = krylov.tridiag_eigh(alpha, beta)
    assert torch.isnan(lam[1]).all()
    for b in (0, 2):
        lb, qb = krylov.tridiag_eigh(alpha[b], beta[b])
        assert torch.equal(lam[b], lb) and torch.equal(Q[b], qb)
    coef = krylov.coefficients("exp", 0.1j, lam, Q, torch.ones(B))
    assert torch.isnan(coef[1]).all() and torch.isfinite(coef[[0, 2]]).all()


def _ic(shape, seed):
    ny, nx = shape
    y = np.linspace(-LX, LX, ny)[:, None]
    x = np.linspace(-LX, LX, nx)[None, :]
    u0 = np.stack([np.exp(-((x - 0.4 * b) ** 2 + y ** 2) / (2.0 + 0.3 * b))
                   * np.exp(0.5j * (1 + b) * x) for b in range(B)])
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    m = (1.0 + 0.1 * rng.standard_normal((B,) + shape)).astype(np.float32)
    c = (1.0 + 0.4 * rng.random((B,) + shape)).astype(np.float32)
    return packed, m, c


def _alone(packed, m, c, shape, snaps, freq, use_c, lanes=range(B)):
    """The lanes' nlse_problem each run alone, as (lanes, S, 2, ny, nx)."""
    out = []
    for b in lanes:
        prob = problems.nlse_problem(
            "cubic", shape, LX, DT, m_field=m[b],
            c_field=c[b] if use_c else None, krylov_m=8, device="cpu")
        assert prob.meta["planar_state"]
        ref = problems.run(prob, prob.init(packed[b]), snaps, freq)
        out.append(torch.stack([ref.real, ref.imag], dim=1))
    return torch.stack(out)


@pytest.mark.parametrize("use_c", [True, False])
def test_batched_ss2_step_matches_lanes_alone(use_c):
    """10 batched SS2 steps on a (B, 2, ny, nx) state against nlse_problem
    run alone on each lane: rel-L2 <= 1e-6 per lane."""
    shape = (24, 40)
    packed, m, c = _ic(shape, 70)
    dx = 2.0 * LX / (shape[1] - 1)
    desc = (tops.batched_aniso_laplacian_2d(list(_t(c)), dx, dx,
                                            device="cpu") if use_c
            else tops.laplacian_2d(shape, dx, dx, device="cpu").kernel_desc)
    rho = nlse_density_planar("cubic", _t(m))
    grid = tk.kick_grid(shape)
    up = _t(packed)
    for _ in range(10):
        up = nlse.ss2_step_planar(up, desc, rho, DT, m=8, grid=grid)
    want = _alone(packed, m, c, shape, 2, 10, use_c)[:, -1]
    worst = max(float((up[b] - want[b]).norm() / want[b].norm())
                for b in range(B))
    print(f"batched SS2 vs each lane alone after 10 steps "
          f"({'c(x)' if use_c else 'iso'}): max rel-L2 {worst:.3e}")
    assert worst <= 1e-6


@pytest.mark.parametrize("use_c", [True, False])
def test_batched_engine_matches_jax_interpret(jax_interpret, use_c):
    """The port's batched engine against JAX's vmapped engine with its
    Pallas kernels in interpret mode: B = 3, m = 6, 32 x 128."""
    shape = (32, 128)
    packed, m, c = _ic(shape, 80)
    kw = dict(integrator="ss2", krylov_m=6, use_c=use_c)
    assert _jax_planar(shape, use_c)
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", shape, LX, DT, dtype=jnp.complex64, **kw)(
        packed, m, c if use_c else None, 2, 2))
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT,
                                      dtype=torch.complex64, device="cpu",
                                      **kw)
    assert fn.planar and fn.batched
    got = fn(packed, m, c if use_c else None, 2, 2).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for b in range(B):
        r = np.linalg.norm(got[b, 1] - want[b, 1]) / np.linalg.norm(
            want[b, 1])
        print(f"lane {b}: rel-L2 vs JAX {r:.3e}")
        assert r <= 1e-5


def test_nan_lane_stays_confined():
    """Lane 1 starts as NaN: its snapshots are NaN and bad_at flags it at
    snapshot 0; lanes 0 and 2 equal their runs alone."""
    shape, snaps, freq = (24, 40), 3, 3
    packed, m, c = _ic(shape, 90)
    packed[1] = np.nan
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=8,
                                      guard=True, record_energy=True,
                                      device="cpu")
    assert fn.batched
    snaps_, bad_at, series = fn(packed, m, c, snaps, freq)
    assert bad_at.tolist() == [snaps, 0, snaps]
    assert torch.isnan(snaps_[1]).all()
    assert torch.isnan(series["mass"][1]).all()
    assert torch.isfinite(series["mass"][[0, 2]]).all()
    alone = _alone(packed, m, c, shape, snaps, freq, True, (0, 2))
    assert torch.equal(snaps_[[0, 2]], alone)


def test_batch_under_switches_takes_k5_and_k8(monkeypatch):
    """A batch runs the loop one lane would take: with config.fused_iter
    (2D or 3D) the fused loop, one K5 call per iteration for all lanes;
    with config.pipeline_3d a 3D batch the pipelined loop, one K8 call per
    iteration but the last; with neither, the 3D batch the two-pass loop.
    Each returns B-lane columns and (B,) scalars."""
    u = torch.zeros((B, 2, 8, 8))
    desc = tops.laplacian_2d((8, 8), 0.1, 0.1, device="cpu").kernel_desc
    d3 = tops.laplacian_3d((4, 4, 4), 0.1, device="cpu").kernel_desc
    u3 = torch.zeros((B, 2, 16, 4))
    calls = {"iter": 0, "pipe": 0, "pass1": 0}
    for name, mod, attr in (("iter", t3, "iter_step"), ("pipe", t3, "pipe_3d"),
                            ("pass1", t3, "pass1_3d")):
        real = getattr(mod, attr)

        def counted(*a, _n=name, _f=real):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(mod, attr, counted)

    def run(v, d):
        W, s, alphas, betas, beta0 = tl.lanczos_planar(v, d, 4)
        assert len(W) == 4 and W[3].shape == v.shape
        assert beta0.shape == (B,) and betas[0].shape == (B,)

    monkeypatch.setattr(config, "fused_iter", True)
    for v, d in ((u, desc), (u3, d3)):
        run(v, d)
    assert calls == {"iter": 6, "pipe": 0, "pass1": 0}
    monkeypatch.setattr(config, "fused_iter", False)
    monkeypatch.setattr(config, "pipeline_3d", True)
    run(u3, d3)
    assert calls == {"iter": 6, "pipe": 2, "pass1": 1}
    monkeypatch.setattr(config, "pipeline_3d", False)
    run(u3, d3)
    assert calls == {"iter": 6, "pipe": 2, "pass1": 4}
