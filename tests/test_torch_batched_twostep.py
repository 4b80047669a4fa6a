"""The batched two-step NLSE datagen step of the port on the CPU.

The datagen engine's planar sEWI, fused sEWI and Gautschi integrators step
all B lanes at once: the state is a pair (u, u_prev) of (B, 2, R, nx)
float32 tensors, step index 1 is the batched SS2 bootstrap, every later
step is the batched two-step step (three or two batched matrix functions),
and the ghost copy follows it (the plain copy in 2D, one batched bc3d in
3D). On the CPU the kernel wrappers take their plain versions, vectorised
over the lanes.

* The planar two-step terms on a batch, B = 2 (where a wrong axis gives a
  tensor of the right shape): i u and B(u) = -rho(u) u of each lane equal
  the unbatched terms, bit for bit.
* The batched engine (pipeline/engine.make_nlse_trajectory_fn,
  integrator sewi / sewi_fused / gautschi) in 2D at 24 x 40 and 3D at
  5 x 6 x 12, iso and c(x), B = 2 and 3: `batched` is true and each lane
  after 6 steps (the bootstrap and five two-step steps) equals nlse_problem
  run alone with its m and c, bit for bit.
* The batched engine against JAX's vmapped engine with its Pallas kernels
  in interpret mode, as tests/test_torch_batched.py runs it, in 2D at
  32 x 128 with c(x), B = 2, m = 6, 3 steps: the initial snapshot equal, the
  last within rel-L2 1e-5 per lane (the gate of
  tests/test_torch_twostep.py). 3D: tests/test_torch_batched_twostep3d.py.
* A lane started as NaN, 2D and 3D: its snapshots and mass series are NaN,
  bad_at flags it at snapshot 0, and the other lanes equal their runs
  alone bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch.models import nlse, problems
from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
from nlsolvers_tpu_torch.pipeline import engine as teng
from test_torch_datagen import _jax_planar, jax_interpret  # noqa: F401

torch.set_num_threads(1)

LX, DT = 5.0, 1e-3
INTEGRATORS = ("sewi", "sewi_fused", "gautschi")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def nlse_ic(B, shape, seed):
    """(packed u0, m, c) of B complex lanes on `shape`, float32."""
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


def alone(integrator, shape, packed, m, c, snaps, freq, lanes, m_k=6):
    """Each lane's nlse_problem run alone, as (lanes, S, 2, *shape)."""
    out = []
    for b in lanes:
        prob = problems.nlse_problem(
            "cubic", shape, LX, DT, m_field=m[b],
            c_field=None if c is None else c[b], integrator=integrator,
            krylov_m=m_k, device="cpu")
        assert prob.meta["planar_state"]
        ref = problems.run(prob, prob.init(packed[b]), snaps, freq)
        out.append(torch.stack([ref.real, ref.imag], dim=1))
    return torch.stack(out)


def test_planar_twostep_terms_batched_b2():
    """i u and B(u) on a (2, 2, R, nx) batch: each lane equals the
    unbatched term on that lane (a lane-for-plane mix-up would keep the
    shape at B = 2 and change the numbers)."""
    rng = np.random.default_rng(3)
    up = _t(rng.standard_normal((2, 2, 6, 9)))
    m = _t(0.5 + rng.random((2, 6, 9)))
    rho = nlse_density_planar("cubic_quintic", m, sigma1=0.8, sigma2=-0.2)
    iu, bu = nlse._mul_i_planar(up), nlse._B_planar(up, rho)
    for b in range(2):
        lane = nlse_density_planar("cubic_quintic", m[b], sigma1=0.8,
                                   sigma2=-0.2)
        assert torch.equal(iu[b], torch.stack([-up[b, 1], up[b, 0]]))
        assert torch.equal(bu[b], nlse._B_planar(up[b], lane))
        assert torch.equal(bu[b], -lane(up[b]) * up[b])


_ALONE_CASES = [((24, 40), True, 2), ((24, 40), False, 3),
                ((5, 6, 12), True, 3), ((5, 6, 12), False, 2)]


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("shape,use_c,B", _ALONE_CASES,
                         ids=[f"{len(s)}d-{'c' if c else 'iso'}-B{b}"
                              for s, c, b in _ALONE_CASES])
def test_twostep_engine_equals_lanes_alone(integrator, shape, use_c, B):
    """6 batched steps (bootstrap + 5 two-step steps) of every lane equal
    nlse_problem run alone on its m and c, bit for bit."""
    packed, m, c = nlse_ic(B, shape, 20 + B)
    c = c if use_c else None
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      integrator=integrator, use_c=use_c,
                                      device="cpu")
    assert fn.planar and fn.batched
    got = fn(packed, m, c, 3, 3)
    assert got.shape == (B, 3, 2) + shape
    assert torch.equal(got, alone(integrator, shape, packed, m, c, 3, 3,
                                  range(B)))


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_twostep_engine_matches_jax_interpret(jax_interpret, integrator):
    """The port's batched two-step engine with c(x) against JAX's vmapped
    engine with its Pallas kernels in interpret mode: B = 2, m = 6,
    32 x 128, 3 steps."""
    shape = (32, 128)
    packed, m, c = nlse_ic(2, shape, 30)
    kw = dict(integrator=integrator, krylov_m=6)
    assert _jax_planar(shape, True)
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", shape, LX, DT, dtype=jnp.complex64, **kw)(
        packed, m, c, 2, 3))
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT,
                                      dtype=torch.complex64, device="cpu",
                                      **kw)
    assert fn.planar and fn.batched
    got = fn(packed, m, c, 2, 3).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for b in range(2):
        r = np.linalg.norm(got[b, 1] - want[b, 1]) / np.linalg.norm(
            want[b, 1])
        print(f"{integrator} lane {b}: rel-L2 vs JAX {r:.3e}")
        assert r <= 1e-5


@pytest.mark.parametrize("shape", [(24, 40), (5, 6, 12)])
def test_twostep_nan_lane_stays_confined(shape):
    """Lane 1 starts as NaN: its snapshots and mass series are NaN, bad_at
    flags it at snapshot 0, lanes 0 and 2 equal their runs alone."""
    snaps, freq = 3, 2
    packed, m, c = nlse_ic(3, shape, 40)
    packed[1] = np.nan
    fn = teng.make_nlse_trajectory_fn("cubic", shape, LX, DT, krylov_m=6,
                                      integrator="sewi", guard=True,
                                      record_energy=True, device="cpu")
    assert fn.batched
    out, bad_at, series = fn(packed, m, c, snaps, freq)
    assert bad_at.tolist() == [snaps, 0, snaps]
    assert torch.isnan(out[1]).all()
    assert torch.isnan(series["mass"][1]).all()
    assert torch.isfinite(series["mass"][[0, 2]]).all()
    assert torch.equal(out[[0, 2]], alone("sewi", shape, packed, m, c, snaps,
                                          freq, (0, 2)))
