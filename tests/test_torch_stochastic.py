"""The port's stochastic phi-4 model against the JAX package.

torch's generators cannot replay jax.random.fold_in(PRNGKey(seed), i), so
the port's step takes the noise field xi as an argument:
* stochastic_sv_step given JAX's xi for step i equals JAX's step, float64,
  2D and 3D: rtol 1e-12;
* the problem's step i is that step with stochastic_noise(seed, i) and the
  ghost copy, bit for bit; one seed gives equal runs, another seed or
  another step index other noise;
* the noise is N(0, 1): mean and standard deviation within 5 sigma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.models import realwave as jrw
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.models import realwave as trw
from nlsolvers_tpu_torch.ops import boundaries as tbcs
from nlsolvers_tpu_torch.ops import operators as tops

torch.set_num_threads(1)

LX, DT, SIGMA = 5.0, 1e-2, 0.1


def _lap(shape):
    dx = 2.0 * LX / (shape[-1] - 1)
    if len(shape) == 2:
        return (jops.laplacian_2d(shape, dx, dx, dtype=np.float64),
                tops.laplacian_2d(shape, dx, dx, dtype=torch.float64,
                                  device="cpu"))
    return (jops.laplacian_3d(shape, dx, dtype=np.float64),
            tops.laplacian_3d(shape, dx, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("shape", [(32, 40), (8, 10, 12)], ids=["2d", "3d"])
@pytest.mark.parametrize("i", [1, 7])
def test_step_with_jax_noise_matches_jax(shape, i):
    rng = np.random.default_rng(i)
    u = 0.5 * rng.standard_normal(shape)
    u_past = u - DT * rng.standard_normal(shape)
    m = 0.5 + rng.random(shape)
    key = jax.random.fold_in(jax.random.PRNGKey(3), i)
    xi = np.array(jax.random.normal(key, shape, jnp.float64))
    jlap, tlap = _lap(shape)
    want = jrw.stochastic_sv_step(jnp.asarray(u), jnp.asarray(u_past), key,
                                  jlap, jnp.asarray(m), DT, SIGMA)
    T = torch.from_numpy
    got = trw.stochastic_sv_step(T(u), T(u_past), T(xi), tlap, T(m), DT,
                                 SIGMA)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)


def _problem(shape, seed=11, dtype=torch.float64):
    return tproblems.stochastic_phi4_problem(shape, LX, DT, seed=seed,
                                             noise_strength=SIGMA,
                                             dtype=dtype, device="cpu")


@pytest.mark.parametrize("shape", [(32, 40), (8, 10, 12)], ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_problem_step_is_the_step_with_its_noise(shape, dtype):
    prob = _problem(shape, dtype=dtype)
    rng = np.random.default_rng(4)
    s = prob.init(0.3 * rng.standard_normal(shape),
                  0.1 * rng.standard_normal(shape))
    u, u_past = s
    m = torch.ones(shape, dtype=dtype)
    _, tlap = _lap(shape)
    if dtype == torch.float32:
        dx = 2.0 * LX / (shape[-1] - 1)
        tlap = (tops.laplacian_2d(shape, dx, dx, device="cpu")
                if len(shape) == 2 else
                tops.laplacian_3d(shape, dx, device="cpu"))
    xi = trw.stochastic_noise(11, 5, u)
    u_new, u_prev = trw.stochastic_sv_step(u, u_past, xi, tlap, m, DT, SIGMA)
    neumann = (tbcs.neumann_no_velocity_2d if len(shape) == 2
               else tbcs.neumann_no_velocity_3d)
    got = prob.step(s, 5)
    assert torch.equal(got[0], neumann(u_new)) and got[1] is u
    assert got[0].dtype == dtype


def test_one_seed_gives_equal_runs():
    shape = (24, 24)
    u0 = 0.2 * np.random.default_rng(5).standard_normal(shape)
    a = tproblems.run(_problem(shape), _problem(shape).init(u0), 4, 3)
    b = tproblems.run(_problem(shape), _problem(shape).init(u0), 4, 3)
    c = tproblems.run(_problem(shape, seed=12), _problem(shape).init(u0),
                      4, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0][-1], c[0][-1])


def test_noise_differs_by_step_and_seed():
    like = torch.zeros((64, 64), dtype=torch.float64)
    x1 = trw.stochastic_noise(0, 1, like)
    assert torch.equal(x1, trw.stochastic_noise(0, 1, like))
    gen = torch.Generator()
    assert torch.equal(x1, trw.stochastic_noise(0, 1, like, generator=gen))
    for other in (trw.stochastic_noise(0, 2, like),
                  trw.stochastic_noise(1, 1, like)):
        assert not torch.equal(x1, other)
        assert abs(float(torch.corrcoef(torch.stack(
            [x1.flatten(), other.flatten()]))[0, 1])) < 0.05


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_noise_is_standard_normal(dtype):
    like = torch.zeros((256, 256), dtype=dtype)
    xi = torch.cat([trw.stochastic_noise(3, i, like).flatten()
                    for i in range(1, 5)]).double()
    n = xi.numel()
    assert xi.dtype == torch.float64 and n == 4 * 256 * 256
    assert abs(float(xi.mean())) < 5.0 / n ** 0.5
    assert abs(float(xi.std()) - 1.0) < 5.0 / (2.0 * n) ** 0.5


def test_jax_problem_and_port_problem_share_the_deterministic_part():
    """With noise_strength 0 both problems are the same SV step."""
    shape = (20, 24)
    u0 = 0.3 * np.random.default_rng(6).standard_normal(shape)
    jp = jproblems.stochastic_phi4_problem(shape, LX, DT, noise_strength=0.0,
                                           dtype=jnp.float64)
    tp = tproblems.stochastic_phi4_problem(shape, LX, DT, noise_strength=0.0,
                                           dtype=torch.float64, device="cpu")
    want = jproblems.run(jp, jp.init(u0), 3, 2)
    got = tproblems.run(tp, tp.init(u0), 3, 2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
