"""The port's trajectory loops against the JAX package's, float64 on the CPU.

* evolve_guarded on a stable real-wave run equals evolve, bad_at == S, and
  JAX's snapshots, bad_at and energy series (rtol 1e-10);
* a diverging phi-4 SV run (|u| > 1 runs away) exits at the same snapshot
  as JAX's, with the same bad_at and a zero-filled tail;
* batched lanes: per-lane bad_at, the run going on while a lane lives, and
  finite_reduce applied to the bits before they drive the exit;
* the early exit reads one flag per snapshot: the step count;
* simulate is evolve; tuple and dict snapshots stack per leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.models import evolve as jev
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.models import evolve as tev
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.models.nonlinearities import realwave_potential

torch.set_num_threads(1)

SHAPE, LX = (24, 28), 5.0


def _pair(kind, dt, integrator):
    kw = dict(integrator=integrator, krylov_m=6)
    return (jproblems.realwave_problem(kind, SHAPE, LX, dt,
                                       dtype=jnp.float64, **kw),
            tproblems.realwave_problem(kind, SHAPE, LX, dt,
                                       dtype=torch.float64, device="cpu",
                                       **kw))


def _energy(kind, dt, xp):
    """0.5 v^2 + m V(u) summed over the grid (the gradient term left out:
    this checks the series plumbing, not the physics)."""
    if xp is torch:
        V = realwave_potential(kind)
        return lambda s: (0.5 * ((s[0] - s[1]) / dt) ** 2 + V(s[0])).sum()
    from nlsolvers_tpu.models.nonlinearities import realwave_potential as jV
    V = jV(kind)
    return lambda s: jnp.sum(0.5 * ((s[0] - s[1]) / dt) ** 2 + V(s[0]))


def _ic(amp, seed=0):
    rng = np.random.default_rng(seed)
    return amp * rng.standard_normal(SHAPE), 0.1 * rng.standard_normal(SHAPE)


def _guarded_pair(kind, dt, integrator, amp, S, freq):
    jp, tp = _pair(kind, dt, integrator)
    u0, v0 = _ic(amp)
    want = jev.evolve_guarded(jp.step, jp.init(u0, v0), S, freq,
                              observe=jp.observe,
                              scalars={"E": _energy(kind, dt, jnp)})
    got = tev.evolve_guarded(tp.step, tp.init(u0, v0), S, freq,
                             observe=tp.observe,
                             scalars={"E": _energy(kind, dt, torch)})
    return tp, (u0, v0), want, got


@pytest.mark.parametrize("integrator", ["gautschi", "sv"])
def test_stable_run_matches_evolve_and_jax(integrator):
    S, freq = 5, 3
    tp, (u0, v0), want, got = _guarded_pair("sine_gordon", 1e-2, integrator,
                                            0.3, S, freq)
    (snaps, bad_at, series), (jsnaps, jbad, jseries) = got, want
    assert bad_at.dtype == torch.int32 and int(bad_at) == S == int(jbad)
    plain = tev.evolve(tp.step, tp.init(u0, v0), S, freq, tp.observe)
    for a, b, c in zip(snaps, plain, jsnaps):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-10,
                                   atol=1e-12)
    assert series["E"].shape == (S,)
    np.testing.assert_allclose(series["E"].numpy(), np.asarray(jseries["E"]),
                               rtol=1e-10)


def test_diverging_run_exits_like_jax():
    """phi-4 SV from |u| ~ 3: the cubic force runs away to inf/NaN."""
    S, freq = 12, 4
    tp, _, want, got = _guarded_pair("phi4", 0.05, "sv", 3.0, S, freq)
    (snaps, bad_at, series), (jsnaps, jbad, jseries) = got, want
    k = int(bad_at)
    assert 1 < k < S and k == int(jbad)
    u, v = snaps
    assert not bool(torch.isfinite(u[k]).all() & torch.isfinite(v[k]).all())
    assert bool(torch.isfinite(u[:k]).all())
    assert not bool(u[k + 1:].any()) and not bool(v[k + 1:].any())
    assert not bool(series["E"][k + 1:].any())
    for a, b in zip(snaps, jsnaps):
        np.testing.assert_allclose(a[:k].numpy(), np.asarray(b)[:k],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(a[k + 1:].numpy(),
                                      np.asarray(b)[k + 1:])
    np.testing.assert_allclose(series["E"][:k].numpy(),
                               np.asarray(jseries["E"])[:k], rtol=1e-10)


def test_exit_stops_the_steps():
    """After the snapshot at which every lane is bad, no step runs."""
    calls = []

    def step(x, i):
        calls.append(i)
        return x * 1e100

    snaps, bad_at, _ = tev.evolve_guarded(step, torch.ones(3,
                                          dtype=torch.float64), 10, 2)
    assert int(bad_at) == 2 and calls == [1, 2, 3, 4]
    assert not bool(snaps[3:].any())


def _lanes(xp):
    growth = xp.asarray([1.0, 1e100, 1e30]) if xp is jnp else torch.tensor(
        [1.0, 1e100, 1e30], dtype=torch.float64)

    def step(x, i):
        del i
        return x * growth[:, None]

    return step


@pytest.mark.parametrize("reduce", [False, True])
def test_batched_lanes_and_finite_reduce_match_jax(reduce):
    """Lane 1 overflows at snapshot 2, lane 2 at snapshot 6, lane 0 never.
    With finite_reduce (every lane dies with the first), the run exits at
    snapshot 2 for every lane."""
    S, freq = 9, 2
    x0 = np.ones((3, 4))
    jred = (lambda ok: ok & jnp.all(ok)) if reduce else None
    tred = (lambda ok: ok & ok.all()) if reduce else None
    scal_j = {"max": lambda x: jnp.max(jnp.abs(x), axis=1)}
    scal_t = {"max": lambda x: x.abs().amax(dim=1)}
    jsn, jbad, jser = jev.evolve_guarded(_lanes(jnp), jnp.asarray(x0), S,
                                         freq, batched=True, scalars=scal_j,
                                         finite_reduce=jred)
    tsn, tbad, tser = tev.evolve_guarded(_lanes(torch), torch.from_numpy(x0),
                                         S, freq, batched=True,
                                         scalars=scal_t, finite_reduce=tred)
    assert tbad.dtype == torch.int32 and tbad.shape == (3,)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert tbad.tolist() == ([2, 2, 2] if reduce else [9, 2, 6])
    np.testing.assert_array_equal(tsn.numpy(), np.asarray(jsn))
    np.testing.assert_array_equal(tser["max"].numpy(),
                                  np.asarray(jser["max"]))


def test_nonfinite_initial_condition():
    x0 = torch.tensor([1.0, float("nan")], dtype=torch.float64)
    snaps, bad_at, _ = tev.evolve_guarded(lambda x, i: x, x0, 4, 1)
    assert int(bad_at) == 0 and not bool(snaps[1:].any())


def test_simulate_is_evolve_and_trees_stack():
    def step(s, i):
        return {"a": s["a"] + i, "b": (s["b"][0] * 2,)}

    s0 = {"a": torch.zeros(2), "b": (torch.ones(3),)}
    out = tev.simulate(step, s0, 3, 2)
    assert out["a"].shape == (3, 2) and out["b"][0].shape == (3, 3)
    assert out["a"][:, 0].tolist() == [0.0, 3.0, 10.0]
    assert out["b"][0][:, 0].tolist() == [1.0, 4.0, 16.0]
    ev = tev.evolve(step, s0, 3, 2)
    assert torch.equal(ev["a"], out["a"])
