"""The batched real-wave and 3D datagen steps of the port on the CPU.

A batch is B fields with a leading lane axis, the form that jax.vmap gives
the JAX package's datagen engine: the 3D kernels pass1_3d, pass2 (and its
norm-only form) and bc3d take the lanes in one launch, the scalar
recurrence of the two-pass 3D loop runs on (B, ...) tensors, and the 2D and
3D real-wave Gautschi steps and the 3D NLSE SS2 step step every lane at
once. On the CPU the wrappers take the kernels' plain versions, vectorised
over the lanes.

* Each batched plain version equals the unbatched one lane by lane, bit for
  bit, at B = 3 on seeded numpy inputs: pass1_3d (iso reference, iso
  clean, c(x); P = 1 and 2; ragged grids), pass2 (0, 1 and 5 columns; 0 is
  the norm-only form) and bc3d in place.
* The batched two-pass 3D loop (lanczos3d.lanczos_twopass) equals the
  unbatched loop on each lane, bit for bit.
* The batched engine steps (pipeline/engine: float32 2D and 3D real-wave
  Gautschi, complex64 3D NLSE SS2) against realwave_problem / nlse_problem
  run alone on each lane with device="cpu": bit-equal after 6 steps.
* The batched engine against JAX's vmapped engine with its Pallas kernels
  in interpret mode, as tests/test_pallas.py:731-756 runs it: sine-Gordon
  Gautschi at 32 x 128 (rtol 2e-5, atol 2e-6 on u after 2 steps, the gate
  of tests/test_torch_datagen.py's float32 Gautschi engine test), 3D NLSE
  SS2 with c(x) at 16 x 16 x 128 (rel-L2 <= 1e-5 per lane, the gate of
  the 2D one) and 3D Klein-Gordon Gautschi with c(x) at 16 x 16 x 128
  (rtol 2e-5, atol 2e-6), B = 2, m = 6; the initial snapshot equal.
* A lane started as NaN on each new path: its snapshots are NaN, bad_at
  flags it at snapshot 0, its series is NaN, and the other lanes equal
  their runs alone bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch.models import problems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.boundaries import neumann_no_velocity_3d
from nlsolvers_tpu_torch.ops.cuda import bc3d as tb
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.pipeline import engine as teng
from test_torch_datagen import jax_interpret  # noqa: F401

torch.set_num_threads(1)

B, LX, DT = 3, 5.0, 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _descs(op, shape, seed):
    """(batched descriptor, the lanes' own descriptors) of a 3D operator:
    the iso Laplacian (reference or clean variant) or c(x)."""
    dx = 0.2
    if op != "aniso":
        d = tops.laplacian_3d(shape, dx, variant=op,
                              device="cpu").kernel_desc
        return d, [d] * B
    c = 1.0 + 0.4 * np.random.default_rng(seed).random((B,) + shape)
    lanes = [tops.anisotropic_laplacian_3d(c[b], dx,
                                           device="cpu").kernel_desc
             for b in range(B)]
    return tops.batched_aniso_laplacian_3d(list(c), dx,
                                           device="cpu"), lanes


def _lanes_equal(got, want_of):
    for b in range(B):
        for x, y in zip(got, want_of(b)):
            assert torch.equal(x[b], y)


@pytest.mark.parametrize("op", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("P,shape", [(2, (4, 5, 16)), (1, (3, 7, 9))])
def test_plain_pass1_3d_batched_equal_lanes(op, P, shape):
    """pass1_3d's plain version on (B, P, R, nx) with per-lane scalars (and
    face weights) equals the unbatched one on each lane, bit for bit."""
    rng = np.random.default_rng(10 + P)
    desc, lanes = _descs(op, shape, 11)
    R, nx = shape[0] * shape[1], shape[2]
    cols = [_t(rng.standard_normal((B, P, R, nx))) for _ in range(5)]
    for j in (0, 1, 4):
        scal = _t(rng.uniform(-1, 1, (B, 1, 2)))
        _lanes_equal(t3.pass1_3d(scal, cols[j], cols[:j], desc),
                     lambda b: t3.pass1_3d(scal[b], cols[j][b],
                                           [w[b] for w in cols[:j]],
                                           lanes[b]))


@pytest.mark.parametrize("P", [1, 2])
def test_plain_pass2_batched_equal_lanes(P):
    """pass2's plain version (0 columns: the norm-only form) on a batch
    equals the unbatched one on each lane, bit for bit; the norm form
    returns the field and its squared norm."""
    rng = np.random.default_rng(20 + P)
    w = _t(rng.standard_normal((B, P, 21, 9)))
    cols = [_t(rng.standard_normal((B, P, 21, 9))) for _ in range(5)]
    for nw in (0, 1, 5):
        q = _t(rng.uniform(-0.5, 0.5, (B, nw, 2))) if nw else None
        got = t3.pass2(q, w, cols[:nw])
        assert got[1].shape == (B, 1, 1)
        _lanes_equal(got, lambda b: t3.pass2(
            None if q is None else q[b], w[b], [c[b] for c in cols[:nw]]))
    wn, nsq = t3.pass2(None, w, [])
    assert wn is w
    torch.testing.assert_close(nsq[:, 0, 0], (w * w).sum(dim=(1, 2, 3)))


@pytest.mark.parametrize("P", [1, 2])
def test_plain_bc3d_batched_equal_lanes(P):
    """bc3d's plain version on a (B, P, R, nx) batch, in place, equals the
    unbatched copy on each lane and the plain 6-face copy."""
    shape = (4, 5, 6)
    rng = np.random.default_rng(30 + P)
    up = _t(rng.standard_normal((B, P, 20, 6)))
    alone = [tb.neumann_bc_planar_3d(up[b].clone(), shape) for b in range(B)]
    want = neumann_no_velocity_3d(up.view(B, P, *shape)).reshape(up.shape)
    got = tb.neumann_bc_planar_3d(up, shape)
    assert got is up
    assert torch.equal(got, want)
    for b in range(B):
        assert torch.equal(got[b], alone[b])


@pytest.mark.parametrize("op", ["reference", "aniso"])
@pytest.mark.parametrize("P", [1, 2])
def test_twopass_batched_equals_lanes(op, P):
    """The two-pass 3D loop on a batch: W, s, alpha, beta and beta0 of
    each lane equal the unbatched loop's on that lane, bit for bit."""
    shape = (4, 6, 10)
    desc, lanes = _descs(op, shape, 41)
    u = _t(np.random.default_rng(40 + P).standard_normal((B, P, 24, 10)))
    got = t3.lanczos_twopass(u, desc, 6)
    for b in range(B):
        want = t3.lanczos_twopass(u[b], lanes[b], 6)
        for xs, ys in zip(got[:4], want[:4]):
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert torch.equal(x[b], y)
        assert torch.equal(got[4][b], want[4])


def _rw_ic(shape, seed):
    """(u0, v0, m, c) of B real lanes, float32."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-LX, LX, shape[-1])
    u0 = np.stack([4.0 * np.arctan(np.exp(-(x + 0.3 * b) / 1.5))
                   * np.ones(shape) for b in range(B)])
    v0 = 0.05 * rng.standard_normal((B,) + shape)
    m = 0.5 + rng.random((B,) + shape)
    c = 1.0 + 0.4 * rng.random((B,) + shape)
    return tuple(a.astype(np.float32) for a in (u0, v0, m, c))


def _nlse_ic(shape, seed):
    """(packed u0, m, c) of B complex lanes, float32."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-LX, LX, n) for n in shape],
                        indexing="ij")
    r2 = sum(g ** 2 for g in grids)
    u0 = np.stack([np.exp(-r2 / (2.0 + 0.3 * b))
                   * np.exp(0.5j * (1 + b) * grids[-1]) for b in range(B)])
    packed = np.stack([u0.real, u0.imag], axis=1)
    m = 1.0 + 0.1 * rng.standard_normal((B,) + shape)
    c = 1.0 + 0.4 * rng.random((B,) + shape)
    return tuple(a.astype(np.float32) for a in (packed, m, c))


RW_CASES = [("sine_gordon", (12, 20), True),
            ("klein_gordon", (12, 20), False),
            ("sine_gordon", (5, 6, 12), False),
            ("klein_gordon", (5, 6, 12), True)]


def _rw_alone(kind, shape, u0, v0, m, c, use_c, snaps, freq, lanes):
    out = []
    for b in lanes:
        prob = problems.realwave_problem(
            kind, shape, LX, DT, m_field=m[b],
            c_field=c[b] if use_c else None, krylov_m=6,
            dtype=torch.float32, device="cpu")
        out.append(problems.run(prob, prob.init(u0[b], v0[b]), snaps, freq))
    return [torch.stack([o[k] for o in out]) for k in (0, 1)]


@pytest.mark.parametrize("kind,shape,use_c", RW_CASES)
def test_batched_realwave_engine_equals_lanes_alone(kind, shape, use_c):
    """The batched float32 Gautschi engine, 2D and 3D, iso and c(x): u and
    v of each lane after 6 steps equal realwave_problem run alone."""
    u0, v0, m, c = _rw_ic(shape, 50)
    fn = teng.make_realwave_trajectory_fn(kind, shape, LX, DT, krylov_m=6,
                                          use_c=use_c, device="cpu")
    assert fn.batched
    u, v = fn(u0, v0, m, c if use_c else None, 3, 3)
    wu, wv = _rw_alone(kind, shape, u0, v0, m, c, use_c, 3, 3, range(B))
    assert torch.equal(u, wu) and torch.equal(v, wv)


def test_realwave_engine_unbatched_paths():
    """SV, float64, reorth=False and stochastic phi-4 stay lane by lane."""
    shape = (8, 10)
    for kw in (dict(integrator="sv"), dict(dtype=torch.float64),
               dict(reorth=False)):
        assert not teng.make_realwave_trajectory_fn(
            "sine_gordon", shape, LX, DT, device="cpu", **kw).batched
    assert not teng.make_realwave_trajectory_fn(
        "stochastic_phi4", shape, LX, DT, device="cpu").batched


@pytest.mark.parametrize("use_c", [True, False])
def test_batched_nlse_3d_engine_equals_lanes_alone(use_c):
    """The batched complex64 3D SS2 engine: each lane after 6 steps equals
    nlse_problem run alone on its m and c."""
    shape = (5, 6, 12)
    packed, m, c = _nlse_ic(shape, 60)
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      use_c=use_c, device="cpu")
    assert fn.planar and fn.batched
    got = fn(packed, m, c if use_c else None, 3, 3)
    assert got.shape == (B, 3, 2) + shape
    for b in range(B):
        prob = problems.nlse_problem("cubic", shape, LX, DT, m_field=m[b],
                                     c_field=c[b] if use_c else None,
                                     krylov_m=6, device="cpu")
        ref = problems.run(prob, prob.init(packed[b]), 3, 3)
        assert torch.equal(got[b], torch.stack([ref.real, ref.imag], dim=1))


def _jax_rw(kind, shape, u0, v0, m, c):
    return [np.asarray(x) for x in jeng.make_realwave_trajectory_fn(
        kind, shape, LX, DT, krylov_m=6, dtype=jnp.float32,
        use_c=c is not None)(u0, v0, m, c, 2, 2)]


@pytest.mark.parametrize("kind,shape,use_c", [
    ("sine_gordon", (32, 128), False), ("klein_gordon", (16, 16, 128), True)])
def test_batched_realwave_engine_matches_jax_interpret(jax_interpret, kind,
                                                       shape, use_c):
    """The port's batched real-wave engine against JAX's vmapped engine
    with its Pallas kernels in interpret mode, B = 2, m = 6, 2 steps, from
    rest (v0 = 0: u0 - dt v0 then rounds alike on both sides)."""
    u0, _, m, c = (a[:2] for a in _rw_ic(shape, 70))
    v0 = np.zeros_like(u0)
    c = c if use_c else None
    ju, jv = _jax_rw(kind, shape, u0, v0, m, c)
    fn = teng.make_realwave_trajectory_fn(kind, shape, LX, DT, krylov_m=6,
                                          use_c=use_c, device="cpu")
    assert fn.batched
    tu, tv = (x.numpy() for x in fn(u0, v0, m, c, 2, 2))
    assert tu.shape == ju.shape == (2, 2) + shape
    np.testing.assert_array_equal(tu[:, 0], ju[:, 0])
    np.testing.assert_allclose(tu, ju, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tv[:, 0], jv[:, 0])


def test_batched_nlse_3d_engine_matches_jax_interpret(jax_interpret):
    """The port's batched 3D SS2 engine with c(x) against JAX's vmapped
    engine in interpret mode: B = 2, m = 6, 16 x 16 x 128, 2 steps."""
    shape = (16, 16, 128)
    packed, m, c = (a[:2] for a in _nlse_ic(shape, 80))
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", shape, LX, DT, krylov_m=6, dtype=jnp.complex64)(
        packed, m, c, 2, 2))
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      dtype=torch.complex64, device="cpu")
    assert fn.planar and fn.batched
    got = fn(packed, m, c, 2, 2).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for b in range(2):
        r = np.linalg.norm(got[b, 1] - want[b, 1]) / np.linalg.norm(
            want[b, 1])
        print(f"3D SS2 lane {b}: rel-L2 vs JAX {r:.3e}")
        assert r <= 1e-5


@pytest.mark.parametrize("path", ["rw2d", "rw3d", "nlse3d"])
def test_nan_lane_stays_confined(path):
    """Lane 1 starts as NaN: its snapshots and series are NaN, bad_at
    flags it at snapshot 0, and lanes 0 and 2 equal their runs alone."""
    snaps, freq = 3, 2
    if path == "nlse3d":
        shape = (5, 6, 12)
        packed, m, c = _nlse_ic(shape, 90)
        packed[1] = np.nan
        fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT,
                                          krylov_m=6, guard=True,
                                          record_energy=True, device="cpu")
        assert fn.batched
        out, bad_at, series = fn(packed, m, c, snaps, freq)
        series = series["mass"]
        alone = torch.cat([fn(packed[b:b + 1], m[b:b + 1], c[b:b + 1],
                              snaps, freq)[0] for b in (0, 2)])
        got = out[[0, 2]]
    else:
        shape = (12, 20) if path == "rw2d" else (5, 6, 12)
        u0, v0, m, c = _rw_ic(shape, 90)
        u0[1] = np.nan
        fn = teng.make_realwave_trajectory_fn(
            "klein_gordon", shape, LX, DT, krylov_m=6, guard=True,
            record_energy=True, device="cpu")
        assert fn.batched
        u, v, bad_at, series = fn(u0, v0, m, c, snaps, freq)
        series = series["energy"]
        out = u
        wu, wv = _rw_alone("klein_gordon", shape, u0, v0, m, c, True, snaps,
                           freq, (0, 2))
        got, alone = torch.cat([u[[0, 2]], v[[0, 2]]]), torch.cat([wu, wv])
    assert bad_at.tolist() == [snaps, 0, snaps]
    assert torch.isnan(out[1]).all() and torch.isnan(series[1]).all()
    assert torch.isfinite(series[[0, 2]]).all()
    assert torch.equal(got, alone)
