"""The batched fused iteration (K5, config.fused_iter) and 3D pipe (K8,
config.pipeline_3d) of the port on the CPU.

Under either switch a batch of B lanes (B, P, R, nx) runs the loop one lane
would take, one K5 or K8 launch per iteration for all lanes; on the CPU the
wrappers take the kernels' plain versions (iter_ref, pipe_3d_ref),
vectorised over the lanes.

* The plain versions on a batch, B = 2 and 3, P = 1 and 2, every operator
  mode (K5: iso2d reference and clean, aniso2d, iso3d reference and
  clean; K8: iso3d reference and clean, aniso3d), on ragged grids: each
  lane equals the unbatched call, bit for bit.
* The batched fused loop (2D iso and c(x), 3D iso) and the batched
  pipelined 3D loop (iso and c(x)) equal the unbatched runs on each lane,
  bit for bit, through one K5 / K8 call per iteration for all lanes.
* K5's plan on a batch (lanczos2d.iter_plan with B lanes, under the H100's
  shared-memory budget of tests/test_torch_fused_iter.py): one lane's
  grid; w on chip where the blocks hold every lane's rows, else the global
  form on that grid; B = 1 is the unbatched plan.
* The FUSED_ITER_BYTES gate is per lane, as JAX's P * ny * nx * 4 <= 32 MiB
  is under vmap: a batch whose lanes are each under it takes K5, and at
  4 lanes of exactly 32 MiB and just over, the port takes K5 where JAX's
  vmapped loop, traced only, reaches _iter_call.
* The engine's batched SS2 step (and the real-wave Gautschi step) under
  each switch: each lane equals its problem run alone, bit for bit; and
  against JAX's vmapped engine under _FUSED_ITER (2D and 3D iso) or
  pallas_pipeline_3d (3D iso and c(x)), its Pallas kernels in interpret
  mode (JAX's _iter_call / _pipe3d_call seen in the trace): B = 2, m = 6,
  2 steps, rel-L2 <= 1e-5 per lane (tests/test_torch_fused_iter.py's
  FIELD_TOL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu.ops.pallas import lanczos3d_pipe as j3
from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.models import problems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.pipeline import engine as teng
from test_torch_batched_twostep import LX, DT, alone, nlse_ic
from test_torch_datagen import jax_interpret  # noqa: F401
from test_torch_fused_iter import H100_SMEM, _PLAN_CASES, _budget_fit

torch.set_num_threads(1)

FIELD_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _descs(op, shape, B, seed=5):
    """(batched descriptor, the lanes' own) of a 2D or 3D operator: the
    Laplacian ("reference" / "clean" variant) or c(x) ("aniso")."""
    dx = 0.2
    if op != "aniso":
        d = (tops.laplacian_2d(shape, dx, dx, variant=op, device="cpu")
             if len(shape) == 2 else
             tops.laplacian_3d(shape, dx, variant=op, device="cpu"))
        return d.kernel_desc, [d.kernel_desc] * B
    c = 1.0 + 0.4 * np.random.default_rng(seed).random((B,) + shape)
    if len(shape) == 2:
        lanes = [tops.anisotropic_laplacian_2d(c[b], dx, dx, device="cpu")
                 for b in range(B)]
        return tops.batched_aniso_laplacian_2d(list(c), dx, dx,
                                               device="cpu"), [
            x.kernel_desc for x in lanes]
    lanes = [tops.anisotropic_laplacian_3d(c[b], dx, device="cpu")
             for b in range(B)]
    return tops.batched_aniso_laplacian_3d(list(c), dx, device="cpu"), [
        x.kernel_desc for x in lanes]


def _cols(B, P, shape, n, seed):
    rows = int(np.prod(shape[:-1]))
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal((B, P, rows, shape[-1])))
            for _ in range(n)]


def _lanes_equal(got, want_of, B):
    for b in range(B):
        for x, y in zip(got, want_of(b)):
            assert torch.equal(x[b], y)


_K5_MODES = [("reference", (13, 21)), ("clean", (16, 32)),
             ("aniso", (13, 21)), ("reference", (3, 7, 9)),
             ("clean", (4, 5, 16))]


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("op,shape", _K5_MODES,
                         ids=[f"{o}{len(s)}d" for o, s in _K5_MODES])
def test_plain_iter_batched_equals_lanes(op, shape, P, B):
    """iter_step's plain version on a batch (per-lane scalars and face
    weights) equals the unbatched call on each lane, j = 0, 1 and 4."""
    desc, lanes = _descs(op, shape, B)
    cols = _cols(B, P, shape, 5, 10 + P + B)
    rng = np.random.default_rng(20 + B)
    for j in (0, 1, 4):
        scal = _t(rng.uniform(-1, 1, (B, 1, j + 3)))
        got = tl.iter_step(scal, cols[j], cols[:j], desc)
        assert got[1].shape == (B, j + 1, 2) and got[2].shape == (B, 1, 1)
        _lanes_equal(got, lambda b: tl.iter_step(
            scal[b], cols[j][b], [w[b] for w in cols[:j]], lanes[b]), B)


_K8_MODES = [("reference", (4, 5, 16)), ("clean", (3, 7, 9)),
             ("aniso", (3, 7, 9))]


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("op,shape", _K8_MODES,
                         ids=[f"{o}-{s[-1]}" for o, s in _K8_MODES])
def test_plain_pipe3d_batched_equals_lanes(op, shape, P, B):
    """pipe_3d's plain version on a batch equals the unbatched call on each
    lane, j = 0, 2 and 5."""
    desc, lanes = _descs(op, shape, B)
    cols = _cols(B, P, shape, 8, 30 + P + B)
    rng = np.random.default_rng(40 + B)
    for j in (0, 2, 5):
        scal = _t(rng.uniform(-0.5, 0.5, (B, j + 2, 2)))
        got = t3.pipe_3d(scal, cols[7], cols[:j + 1], desc)
        assert got[2].shape == (B, 1, 1) and got[4].shape == (B, j + 2, 2)
        _lanes_equal(got, lambda b: t3.pipe_3d(
            scal[b], cols[7][b], [w[b] for w in cols[:j + 1]], lanes[b]), B)


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))


_LOOPS = [("fused_iter", "reference", (12, 20), 2),
          ("fused_iter", "aniso", (12, 20), 1),
          ("fused_iter", "clean", (4, 5, 12), 2),
          ("pipeline_3d", "reference", (4, 5, 12), 2),
          ("pipeline_3d", "aniso", (4, 5, 12), 1)]


@pytest.mark.parametrize("switch,op,shape,P", _LOOPS,
                         ids=[f"{w}-{o}{len(s)}d-P{p}"
                              for w, o, s, p in _LOOPS])
def test_batched_loop_equals_lanes(monkeypatch, switch, op, shape, P):
    """lanczos_planar on a batch of 3 under the switch: W, s, alpha, beta
    and beta0 of each lane equal the unbatched run's, bit for bit, with one
    K5 / K8 call per iteration for all lanes."""
    B, m = 3, 6
    monkeypatch.setattr(config, switch, True)
    calls = []
    if switch == "fused_iter":
        _counting(monkeypatch, t3, "iter_step", calls)
    else:
        _counting(monkeypatch, t3, "pipe_3d", calls)
    desc, lanes = _descs(op, shape, B)
    (u,) = _cols(B, P, shape, 1, 50 + P)
    got = tl.lanczos_planar(u, desc, m)
    assert len(calls) == (m - 1 if switch == "fused_iter" else m - 2)
    for b in range(B):
        want = tl.lanczos_planar(u[b], lanes[b], m)
        for xs, ys in zip(got[:4], want[:4]):
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert torch.equal(x[b], y)
        assert torch.equal(got[4][b], want[4])


@pytest.mark.parametrize("P,rows,nx,budget,onchip,grid", _PLAN_CASES)
def test_iter_plan_one_lane_is_the_unbatched_plan(P, rows, nx, budget,
                                                  onchip, grid):
    """B = 1 gives the unbatched plan."""
    fit = _budget_fit(budget)
    assert tl.iter_plan(P, rows, nx, budget["sms"], fit, 1) == (onchip,
                                                                 grid)


# (P, rows, nx, B, onchip, grid) under the H100 budget: 8 x 256^2 keeps w
# on chip (2 rows a block and lane); 8 x 128^3 (63 rows a block and lane)
# and 3 x 1024^2 take the global form on one lane's grid; 2048^2 is global
# for one lane already
_BATCH_PLANS = [(2, 256, 256, 8, True, 264), (1, 256, 256, 8, True, 264),
                (2, 128 * 128, 128, 8, False, 264),
                (2, 1024, 1024, 3, False, 264),
                (2, 2048, 2048, 8, False, 264),
                (2, 37, 131, 4, True, 74)]


@pytest.mark.parametrize("P,rows,nx,B,onchip,grid", _BATCH_PLANS)
def test_iter_plan_batch_keeps_one_lanes_grid(P, rows, nx, B, onchip, grid):
    """A batch takes one lane's grid; w on chip where the blocks hold the
    rows of all B lanes, else the global form, which fits that grid."""
    fit = _budget_fit(H100_SMEM)
    sms = H100_SMEM["sms"]
    assert tl.iter_plan(P, rows, nx, sms, fit, B) == (onchip, grid)
    assert tl.iter_plan(P, rows, nx, sms, fit)[1] == grid
    wrows = -(-(-(-nx // 128) * rows) // grid)
    if onchip:
        assert fit(B * wrows * P * 128 * 4) * sms >= grid
    else:
        assert fit(8 * P * 128 * 4) * sms >= grid


def test_fused_gate_is_per_lane(monkeypatch):
    """A batch whose lanes are each at FUSED_ITER_BYTES takes K5 though
    the batch is larger; one byte less keeps the pipe."""
    monkeypatch.setattr(config, "fused_iter", True)
    calls = []
    _counting(monkeypatch, t3, "iter_step", calls)
    desc, _ = _descs("reference", (12, 20), 4)
    (u,) = _cols(4, 2, (12, 20), 1, 60)
    lane = 2 * 12 * 20 * 4
    monkeypatch.setattr(tl, "FUSED_ITER_BYTES", lane)
    tl.lanczos_planar(u, desc, 4)
    assert len(calls) == 3
    calls.clear()
    monkeypatch.setattr(tl, "FUSED_ITER_BYTES", lane - 1)
    tl.lanczos_planar(u, desc, 4)
    assert not calls


class _Took(Exception):
    pass


@pytest.mark.parametrize("ny", [2048, 2056])
def test_fused_gate_per_lane_as_jax(monkeypatch, ny):
    """B = 4 lanes of (2, ny, 2048): 32 MiB each (128 MiB in all) or just
    over. JAX's vmapped lanczos_planar under _FUSED_ITER, traced only,
    reaches _iter_call exactly when the port's batch takes K5 (the port's
    loops stopped at their first kernel)."""
    import jax
    from nlsolvers_tpu.ops import operators as jops
    monkeypatch.setattr(jl, "_FUSED_ITER", True)
    seen = []
    _counting(monkeypatch, jl, "_iter_call", seen)
    jdesc = jops.laplacian_2d((ny, 2048), 0.01, 0.01,
                              dtype=jnp.float32)._pallas_desc
    jax.eval_shape(jax.vmap(
        lambda u: jl.lanczos_planar(u, jdesc, 3, interpret=True)[0][-1]),
        jax.ShapeDtypeStruct((4, 2, ny, 2048), jnp.float32))
    monkeypatch.setattr(config, "fused_iter", True)

    def took(name):
        def stop(*a, **k):
            raise _Took(name)
        return stop

    monkeypatch.setattr(t3, "pass2",
                        lambda q, w, W: (w, torch.ones(w.shape[:-3] + (1, 1))))
    monkeypatch.setattr(t3, "iter_step", took("K5"))
    monkeypatch.setattr(tl, "_lanczos_pipe", took("pipe"))
    desc = tops.laplacian_2d((ny, 2048), 0.01, 0.01,
                             device="cpu").kernel_desc
    u = torch.zeros((1, 2, ny, 2048)).expand(4, 2, ny, 2048)
    with pytest.raises(_Took) as taken:
        tl.lanczos_planar(u, desc, 3)
    assert (str(taken.value) == "K5") == bool(seen) == (ny == 2048)


_ENGINE_SWITCHES = [("fused_iter", (24, 40), True),
                    ("fused_iter", (5, 6, 12), False),
                    ("pipeline_3d", (5, 6, 12), True),
                    ("pipeline_3d", (5, 6, 12), False)]


@pytest.mark.parametrize("switch,shape,use_c", _ENGINE_SWITCHES,
                         ids=[f"{w}-{len(s)}d-{'c' if c else 'iso'}"
                              for w, s, c in _ENGINE_SWITCHES])
def test_engine_under_switch_equals_lanes_alone(monkeypatch, switch, shape,
                                                use_c):
    """The batched SS2 engine and the batched real-wave Gautschi engine
    under the switch: each lane equals its problem run alone, bit for bit,
    over 4 steps."""
    monkeypatch.setattr(config, switch, True)
    B = 3
    packed, m, c = nlse_ic(B, shape, 70)
    c = c if use_c else None
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      use_c=use_c, device="cpu")
    assert fn.batched
    assert torch.equal(fn(packed, m, c, 3, 2),
                       alone("ss2", shape, packed, m, c, 3, 2, range(B)))
    u0 = packed[:, 0]
    v0 = 0.1 * packed[:, 1]
    rw = teng.make_realwave_trajectory_fn("klein_gordon", shape, LX, DT,
                                          krylov_m=6, use_c=use_c,
                                          device="cpu")
    assert rw.batched
    u, v = rw(u0, v0, m, c, 3, 2)
    for b in range(B):
        prob = problems.realwave_problem(
            "klein_gordon", shape, LX, DT, m_field=m[b],
            c_field=None if c is None else c[b], krylov_m=6,
            dtype=torch.float32, device="cpu")
        wu, wv = problems.run(prob, prob.init(u0[b], v0[b]), 3, 2)
        assert torch.equal(u[b], wu) and torch.equal(v[b], wv)


_JAX_SWITCHES = [("fused_iter", (32, 128), False),
                 ("fused_iter", (16, 16, 128), False),
                 ("pipeline_3d", (16, 16, 128), False),
                 ("pipeline_3d", (16, 16, 128), True)]


@pytest.mark.parametrize("switch,shape,use_c", _JAX_SWITCHES,
                         ids=[f"{w}-{len(s)}d-{'c' if c else 'iso'}"
                              for w, s, c in _JAX_SWITCHES])
def test_engine_under_switch_matches_jax_interpret(
        jax_interpret, monkeypatch, switch, shape, use_c):
    """The batched SS2 engine under the switch against JAX's vmapped
    engine under its own (K5: _FUSED_ITER; K8: pallas_pipeline_3d on the
    y-slab path), B = 2, m = 6, 2 steps."""
    monkeypatch.setattr(config, switch, True)
    seen = []
    if switch == "fused_iter":
        monkeypatch.setattr(jl, "_FUSED_ITER", True)
        _counting(monkeypatch, jl, "_iter_call", seen)
    else:
        monkeypatch.setattr(jconfig, "pallas_ytile_3d", True)
        monkeypatch.setattr(jconfig, "pallas_pipeline_3d", True)
        _counting(monkeypatch, j3, "_pipe3d_call", seen)
    packed, m, c = nlse_ic(2, shape, 80)
    c = c if use_c else None
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", shape, LX, DT, krylov_m=6, dtype=jnp.complex64,
        use_c=use_c)(packed, m, c, 2, 2))
    assert seen, "JAX's vmapped engine did not reach the switched kernel"
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      dtype=torch.complex64, use_c=use_c,
                                      device="cpu")
    assert fn.planar and fn.batched
    got = fn(packed, m, c, 2, 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for b in range(2):
        r = np.linalg.norm(got[b, 1] - want[b, 1]) / np.linalg.norm(
            want[b, 1])
        print(f"{switch} {len(shape)}D lane {b}: rel-L2 vs JAX {r:.3e}")
        assert r <= FIELD_TOL
