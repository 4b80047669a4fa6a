"""Port Krylov core (generic path) vs the JAX package and SciPy, in float64.

Tolerance vs JAX: rel <= 1e-10. Both run the same Lanczos recurrence with
full reorthogonalization in float64; they differ only in summation order
inside the projections and the eigensolver, ~1e-15 relative per operation,
amplified by at most a few orders over m <= 12 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg
import torch

import reference_ops as ref
from nlsolvers_tpu.ops import krylov as jk
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import krylov as tk
from nlsolvers_tpu_torch.ops import operators as tops

torch.set_num_threads(1)

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _dense_pair(L):
    """The same dense matvec in both frameworks."""
    Lj, Lt = jnp.asarray(L), torch.from_numpy(L)
    mvj = lambda u: (Lj.astype(u.dtype) @ u.reshape(-1)).reshape(u.shape)
    mvt = lambda u: (Lt.to(u.dtype) @ u.reshape(-1)).reshape(u.shape)
    return mvj, mvt


def _stencil_pair(n, dx, sign=1.0):
    lj = jops.laplacian_2d((n, n), dx, dx, dtype=jnp.float64)
    lt = tops.laplacian_2d((n, n), dx, dx, dtype=torch.float64,
                           device="cpu")
    if sign == 1.0:
        return lj, lt
    return (lambda u: -lj(u)), (lambda u: -lt(u))


def _u(shape, complex_, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape)
    if complex_:
        u = u + 1j * rng.standard_normal(shape)
    return u


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("reorth", [True, False])
def test_lanczos_matches_jax(complex_, reorth):
    n, m = 40, 12
    A = np.random.default_rng(5).standard_normal((n, n))
    A = (A + A.T) / 2
    u = _u(n, complex_, 6)
    mvj, mvt = _dense_pair(A)
    Vj, aj, bj, b0j = jk.lanczos(mvj, jnp.asarray(u), m, reorth=reorth)
    Vt, at, bt, b0t = tk.lanczos(mvt, torch.from_numpy(u), m, reorth=reorth)
    assert _rel(Vt.numpy(), Vj) <= TOL
    assert _rel(at.numpy(), aj) <= TOL
    assert _rel(bt.numpy(), bj) <= TOL
    assert abs(float(b0t) - float(b0j)) <= TOL * float(b0j)
    assert float(at[-1]) == 0.0          # alpha[m-1] = 0, as the reference


# (t, field) per function: exp/sinc/phi1 take the complex SS2-style time
# on a complex field, the sqrt family a real time on a real field.
FUNC_CASES = {
    "exp": (1j * 1e-2, True),
    "sinc": (5e-3, True),
    "phi1": (1j * 1e-2, True),
    "cos_sqrt": (1e-2, False),
    "sinc2_sqrt": (1e-2, False),
    "id_sqrt": (1e-2, False),
    "sinc2_sqrt_half": (1e-2, False),
    "mod_cosine": (1e-2, False),
}


@pytest.mark.parametrize("func", sorted(FUNC_CASES))
def test_matfunc_apply_matches_jax(func):
    t, complex_ = FUNC_CASES[func]
    assert set(FUNC_CASES) == set(tk.MATFUNCS) == set(jk.MATFUNCS)
    n = 14
    sign = 1.0 if complex_ else -1.0      # the sqrt family on -Lap
    lj, lt = _stencil_pair(n, 0.2, sign)
    u = _u((n, n), complex_, 7)
    want = jk.matfunc_apply(lj, jnp.asarray(u), t, func, m=10)
    got = tk.matfunc_apply(lt, torch.from_numpy(u), t, func, m=10)
    assert _rel(got.numpy(), want) <= TOL


def test_matfunc_apply_multi_matches_singles():
    n = 14
    lj, lt = _stencil_pair(n, 0.2, -1.0)
    u = torch.from_numpy(_u((n, n), False, 8))
    specs = ((1e-2, "id_sqrt"), (1e-2, "cos_sqrt"), (5e-3, "sinc2_sqrt_half"))
    outs = tk.matfunc_apply_multi(lt, u, specs, m=10)
    assert len(outs) == 3
    for (t, func), got in zip(specs, outs):
        single = tk.matfunc_apply(lt, u, t, func, m=10)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("m", [10, 20])
def test_expm_vs_scipy(m):
    """scipy-test/check_krylov_compute.py oracle on the 2D Laplacian, at the
    gate of tests/test_krylov.py (rel < 1e-9)."""
    n_int = 14
    nf = n_int + 2
    dx = 2 * 5.0 / (nf - 1)
    L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    u = _u(nf * nf, True, 9)
    t = 1j * 1e-2
    want = scipy.sparse.linalg.expm_multiply(t * L, u)
    lt = tops.laplacian_2d((nf, nf), dx, dx, dtype=torch.float64,
                           device="cpu")
    got = tk.expm_apply(lt, torch.from_numpy(u.reshape(nf, nf)), t, m=m)
    assert _rel(got.numpy().reshape(-1), want) < 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32, torch.complex64])
def test_zero_start_vector_gives_zero(dtype):
    """f(L) 0 = 0, not NaN (safe normalization), on the generic path and, for
    float32/complex64, on the planar path the stencil's descriptor selects."""
    n = 12
    rd = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    lt = tops.laplacian_2d((n, n), 0.2, 0.2, dtype=rd, device="cpu")
    z = torch.zeros((n, n), dtype=dtype)
    specs = (((1e-3, "sinc"), (1j * 1e-3, "exp")) if dtype.is_complex
             else ((1e-3, "sinc"), (1e-3, "cos_sqrt")))
    outs = tk.matfunc_apply_multi(lt, z, specs, m=8)
    for o in outs:
        assert torch.isfinite(torch.view_as_real(o) if o.is_complex()
                              else o).all()
        assert not o.abs().max() > 0


def test_fused_dispatch_matches_generic():
    """complex64 with a stencil descriptor takes the planar path under
    kernel_mode "auto" and the generic path under "off"; both agree at the
    complex64 tolerance of tests/test_pallas.py (rtol 2e-4, atol 2e-5)."""
    n = 32
    lt = tops.laplacian_2d((n, n), 0.3, 0.3, dtype=torch.float32,
                           device="cpu")
    u = torch.from_numpy(_u((n, n), True, 10).astype(np.complex64))
    fused = tk.matfunc_apply(lt, u, 1j * 1e-3, "exp", m=8)
    old = config.kernel_mode
    config.kernel_mode = "off"
    try:
        generic = tk.matfunc_apply(lt, u, 1j * 1e-3, "exp", m=8)
    finally:
        config.kernel_mode = old
    np.testing.assert_allclose(fused.numpy(), generic.numpy(), rtol=2e-4,
                               atol=2e-5)
