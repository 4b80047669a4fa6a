"""The port's 2D c(x) NLSE path end to end, against the JAX package.

The finite-volume div(c grad u) with c = 1 + 0.4 U[0, 1) runs through the
aniso2d kernels' plain versions (K1', K2') on the CPU:
* planar complex64 problems vs JAX's planar problems with the Pallas kernels
  in interpret mode, after the step-1 bootstrap and 2 more steps at 128^2,
  krylov_m=6, for SS2, sewi, sewi_fused and gautschi: rel-L2 <= 1e-5 (the
  same algorithm in float32; only the summation order differs);
* JAX's sEWI state (u, u_prev) after the bootstrap and its c(x) field,
  carried across with utils/interop, take the same next step: rel-L2 <= 1e-5.
The helpers and the complex128 cases are in tests/test_torch_twostep.py.
"""

import numpy as np
import pytest
import torch

from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.utils import interop
from test_torch_twostep import N, _c, _jax_run, _rel, planar_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("integrator", ["ss2", "sewi", "sewi_fused",
                                        "gautschi"])
def test_planar_problem_matches_jax_interpret(integrator):
    planar_parity(integrator, True)


def test_two_step_state_handed_across_steps_alike():
    """JAX's sEWI state (u, u_prev) after the bootstrap and its 2D c(x)
    field, carried across with utils/interop, take the same next step."""
    meta, states, obs = _jax_run("sewi", True)
    args, kwargs = interop.nlse_args_from_meta(meta, c_field=_c(True))
    assert kwargs["integrator"] == "sewi" and kwargs["c_field"].shape == (N, N)
    m_field = interop.field_from_numpy(np.ones((N, N), np.float32), "cpu")
    prob = tproblems.nlse_problem(*args, m_field=m_field,
                                  dtype=torch.complex64, device="cpu",
                                  **kwargs)
    s = interop.state_from_numpy(states[1], (N, N), "cpu")
    assert isinstance(s, tuple) and tuple(s[0].shape) == (2, N, N)
    got = prob.observe(prob.step(s, 2))
    assert _rel(got.numpy(), obs[2]) <= 1e-5
    with pytest.raises(ValueError):
        interop.state_from_numpy(list(states[1]) * 2, (N, N), "cpu")
