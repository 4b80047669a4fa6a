"""The port's Boussinesq model against the JAX package, in float64 on the
CPU: uxx_1d with its one-sided row ends and biharmonic_x with the
reference's closures (rtol 1e-12), and boussinesq_problem with both
integrators, 5 steps from the same (u0, v0): rtol 1e-10 on u and v. The
operator has no kernel descriptor, so float32 runs the generic path too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.models import boussinesq as jbq
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu_torch.models import boussinesq as tbq
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import operators as tops

torch.set_num_threads(1)


def _u(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("shape", [(5, 9), (3, 40)])
def test_uxx_1d_matches_jax(shape):
    u = _u(shape)
    np.testing.assert_allclose(
        tbq.uxx_1d(torch.from_numpy(u), 0.3).numpy(),
        np.asarray(jbq.uxx_1d(jnp.asarray(u), 0.3)), rtol=1e-12)


@pytest.mark.parametrize("nx", [5, 6, 33])
def test_biharmonic_x_matches_jax(nx):
    shape = (4, nx)
    u = _u(shape, 1)
    got = tops.biharmonic_x(shape, 0.2, dtype=torch.float64,
                            device="cpu")(torch.from_numpy(u))
    want = jops.biharmonic_x(shape, 0.2, dtype=np.float64)(jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-9)


def test_biharmonic_x_rows():
    """The reference's closures on a single row (build_xxxx_noflux)."""
    u = torch.arange(1.0, 8.0, dtype=torch.float64) ** 2
    out = tops.biharmonic_x((1, 7), 1.0, dtype=torch.float64, device="cpu")(
        u[None])[0]
    assert float(out[0]) == 2 * u[0] - 2 * u[1]
    assert float(out[1]) == 4 * u[1] - 2 * u[2] - 2 * u[3]
    assert float(out[3]) == u[1] - 4 * u[2] + 6 * u[3] - 4 * u[4] + u[5]
    assert float(out[5]) == 4 * u[5] - 2 * u[4] - 2 * u[3]
    assert float(out[6]) == 2 * u[6] - 2 * u[5]
    assert tops.biharmonic_x((1, 7), 1.0, device="cpu").__dict__ == {}


@pytest.mark.parametrize("integrator", ["gautschi", "sv"])
@pytest.mark.parametrize("apply_bc", [True, False])
def test_boussinesq_problem_matches_jax(integrator, apply_bc):
    shape, lx, dt = (24, 48), 6.0, 1e-3
    x = np.linspace(-lx, lx, shape[1])
    u0 = np.broadcast_to(0.5 / np.cosh(0.7 * x) ** 2, shape).copy()
    u0 += 0.01 * _u(shape, 2)
    v0 = 0.1 * _u(shape, 3)
    kw = dict(integrator=integrator, krylov_m=8, apply_bc=apply_bc)
    jp = jproblems.boussinesq_problem(shape, lx, dt, dtype=jnp.float64, **kw)
    tp = tproblems.boussinesq_problem(shape, lx, dt, dtype=torch.float64,
                                      device="cpu", **kw)
    assert tp.meta["equation"] == jp.meta["equation"] == "boussinesq"
    want = jproblems.run(jp, jp.init(u0, v0), 3, 2)
    got = tproblems.run(tp, tp.init(u0, v0), 3, 2)
    for a, b in zip(got, want):
        assert a.shape == (3,) + shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    s = tp.init(u0, v0)
    for i in range(1, 6):
        s = tp.step(s, i)
    j = jp.init(u0, v0)
    for i in range(1, 6):
        j = jp.step(j, i)
    for a, b in zip(s, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def test_boussinesq_f32_takes_generic_path():
    """float32 runs too (no descriptor, no kernel): finite and close to the
    float64 run after 5 steps."""
    shape, lx, dt = (16, 32), 6.0, 1e-3
    u0 = 0.3 * np.exp(-np.linspace(-lx, lx, 32) ** 2)[None].repeat(16, 0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        p = tproblems.boussinesq_problem(shape, lx, dt, dtype=dtype,
                                         krylov_m=8, device="cpu")
        s = p.init(u0)
        for i in range(1, 6):
            s = p.step(s, i)
        assert s[0].dtype == dtype
        out[dtype] = s[0].double().numpy()
    np.testing.assert_allclose(out[torch.float32], out[torch.float64],
                               atol=1e-5)


def test_boussinesq_problem_rejects_bad_input():
    with pytest.raises(ValueError):
        tproblems.boussinesq_problem((8, 8), 1.0, 1e-3, integrator="rk4",
                                     device="cpu")
    with pytest.raises(ValueError):
        tproblems.boussinesq_problem((4, 8, 8), 1.0, 1e-3, device="cpu")
