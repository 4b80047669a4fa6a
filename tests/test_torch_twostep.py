"""The port's two-step NLSE integrators (sEWI, fused sEWI, Gautschi), the
radiating BC and the separated operator, end to end against the JAX package.

* planar complex64 problems vs JAX's planar problems with the Pallas kernels
  in interpret mode, after the step-1 bootstrap and 2 more steps at 128^2,
  krylov_m=6: rel-L2 <= 1e-5 (the same algorithm in float32; only the
  summation order differs). sewi, sewi_fused and gautschi on the 5-point
  Laplacian here; on c(x) in tests/test_torch_aniso2d.py, which imports
  this file's helpers; in 3D in tests/test_torch_problems3d.py.
* complex128 problems (the complex path: every two-step integrator, c(x),
  the radiating BC, the separated operator) vs JAX's: rel-L2 <= 1e-10 per
  snapshot, the gate of tests/test_torch_problems.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl

torch.set_num_threads(1)

N, M, LX, DT, STEPS = 128, 6, 5.0, 1e-3, 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u0(n=N, dtype=np.complex64):
    x = np.linspace(-LX, LX, n)
    env = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4)
    return (env * np.exp(0.4j * x[None, :])).astype(dtype)


def _c(aniso, n=N):
    if not aniso:
        return None
    return (1.0 + 0.4 * np.random.default_rng(0).random((n, n))).astype(
        np.float32)


def _kw(integrator, aniso):
    return dict(m_field=np.ones((N, N), np.float32), c_field=_c(aniso),
                krylov_m=M, integrator=integrator)


@functools.lru_cache(maxsize=None)
def _jax_run(integrator, aniso):
    """JAX planar problem with the Pallas kernels in interpret mode: its
    meta, the states after 0..STEPS steps and their observations, numpy."""
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        prob = jproblems.nlse_problem("cubic", (N, N), LX, DT,
                                      dtype=jnp.complex64,
                                      **_kw(integrator, aniso))
        step = jax.jit(prob.step)
        s = prob.init(_u0())
        states = [s]
        for i in range(1, STEPS + 1):
            s = step(s, i)
            states.append(s)
        obs = [np.asarray(prob.observe(x)) for x in states]
        states = [jax.tree_util.tree_map(np.asarray, x) for x in states]
        return prob.meta, states, obs
    finally:
        jconfig.pallas_mode = old


def planar_parity(integrator, aniso):
    """The port's planar problem on the CPU after STEPS steps against JAX's
    in interpret mode; no kernel is launched."""
    meta, _, obs = _jax_run(integrator, aniso)
    assert meta["planar_state"]
    prob = tproblems.nlse_problem("cubic", (N, N), LX, DT,
                                  dtype=torch.complex64, device="cpu",
                                  **_kw(integrator, aniso))
    assert prob.meta["planar_state"] and prob.meta["integrator"] == integrator
    s = prob.init(_u0())
    counters = (tl.pass1_iso2d, tl.pass1_aniso2d, tl.pipe_iso2d,
                tl.pipe_aniso2d, tl.combine)
    before = [f.launches for f in counters]
    for i in range(1, STEPS + 1):
        s = prob.step(s, i)
    assert [f.launches for f in counters] == before      # plain on the CPU
    if integrator != "ss2":
        assert isinstance(s, tuple) and len(s) == 2
        assert all(x.dtype == torch.float32 and tuple(x.shape) == (2, N, N)
                   for x in s)
    got = prob.observe(s)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (N, N)
    assert _rel(got.numpy(), obs[-1]) <= 1e-5


@pytest.mark.parametrize("integrator", ["sewi", "sewi_fused", "gautschi"])
def test_planar_problem_matches_jax_interpret(integrator):
    planar_parity(integrator, False)


COMPLEX_CASES = [dict(integrator="sewi"), dict(integrator="sewi_fused"),
                 dict(integrator="gautschi"),
                 dict(integrator="sewi", aniso=True), dict(aniso=True),
                 dict(bc="radiating"), dict(bc="radiating", integrator="sewi"),
                 dict(variant="separated")]


@pytest.mark.parametrize("case", COMPLEX_CASES,
                         ids=["sewi", "sewi_fused", "gautschi", "sewi-cx",
                              "ss2-cx", "radiating", "radiating-sewi",
                              "separated"])
def test_complex128_path_matches_jax(case):
    """run() on the complex path in float64 at 24^2: rel-L2 <= 1e-10 per
    snapshot (the bootstrap and 5 two-step steps)."""
    n = 24
    case = dict(case)
    c = _c(case.pop("aniso", False), n)
    kw = dict(m_field=np.ones((n, n)), krylov_m=10, c_field=None if c is None
              else c.astype(np.float64), **case)
    pj = jproblems.nlse_problem("cubic", (n, n), LX, DT,
                                dtype=jnp.complex128, **kw)
    pt = tproblems.nlse_problem("cubic", (n, n), LX, DT,
                                dtype=torch.complex128, device="cpu", **kw)
    assert not pt.meta["planar_state"] and not pj.meta["planar_state"]
    u0 = _u0(n, np.complex128)
    want = np.asarray(jproblems.run(pj, pj.init(u0), 4, 2))
    got = tproblems.run(pt, pt.init(u0), 4, 2).numpy()
    assert got.shape == want.shape == (4, n, n)
    for k in range(4):
        assert _rel(got[k], want[k]) <= 1e-10, k


@pytest.mark.parametrize("kw", [dict(shape=(6, 6, 6), bc="radiating"),
                                dict(variant="separated",
                                     c_field=np.ones((6, 6))),
                                dict(shape=(6, 6, 6), variant="separated")],
                         ids=["radiating-3d", "separated-cx", "separated-3d"])
def test_combinations_jax_refuses_raise_value_error(kw):
    kw = dict(kw)
    shape = kw.pop("shape", (6, 6))
    with pytest.raises(ValueError):
        jproblems.nlse_problem("cubic", shape, LX, DT, **kw)
    with pytest.raises(ValueError):
        tproblems.nlse_problem("cubic", shape, LX, DT, device="cpu", **kw)
