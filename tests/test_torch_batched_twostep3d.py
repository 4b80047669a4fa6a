"""The batched 3D two-step NLSE datagen step of the port against JAX's.

The port's batched engine (pipeline/engine.make_nlse_trajectory_fn,
complex64 planar, integrator sewi / sewi_fused / gautschi, c(x)) against
JAX's vmapped engine with its Pallas kernels in interpret mode, as
tests/test_torch_batched3d.py runs the 3D SS2 one: 16 x 16 x 128, B = 2,
m = 6, 3 steps (the bootstrap and two two-step steps, each followed by the
ghost copy, bc3d on the port's side): the initial snapshot equal, the last
within rel-L2 1e-5 per lane (the gate of tests/test_torch_twostep.py). The
2D cases and the lanes-alone checks are tests/test_torch_batched_twostep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch.pipeline import engine as teng
from test_torch_batched_twostep import INTEGRATORS, LX, DT, nlse_ic
from test_torch_datagen import jax_interpret  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_twostep_3d_engine_matches_jax_interpret(jax_interpret, integrator):
    """B = 2, m = 6, 16 x 16 x 128 with c(x), 3 steps."""
    shape = (16, 16, 128)
    packed, m, c = nlse_ic(2, shape, 50)
    kw = dict(integrator=integrator, krylov_m=6)
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
        print(f"3D {integrator} lane {b}: rel-L2 vs JAX {r:.3e}")
        assert r <= 1e-5
