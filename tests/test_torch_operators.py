"""Port operators and boundaries vs the JAX package and dense matrices.

Same seeded numpy inputs through nlsolvers_tpu and nlsolvers_tpu_torch in
float64 on the CPU. Tolerance rel <= 1e-12: the arithmetic is the same
elementwise sequence, so only the last bits may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_ops as ref
from nlsolvers_tpu.ops import boundaries as jbc
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu_torch.ops import boundaries as tbc
from nlsolvers_tpu_torch.ops import operators as tops

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("shape", [(12, 12), (9, 17), (2, 11, 6)])
@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_laplacian_2d_matches_jax(shape, variant):
    u = _field(shape, 1)
    dx, dy = 0.3, 0.3
    lj = jops.laplacian_2d(shape[-2:], dx, dy, variant=variant,
                           dtype=jnp.float64)
    lt = tops.laplacian_2d(shape[-2:], dx, dy, variant=variant,
                           dtype=torch.float64)
    want = np.asarray(lj(jnp.asarray(u)))
    got = lt(torch.from_numpy(u)).numpy()
    assert _rel(got, want) <= TOL
    assert lt.kernel_desc == lj._pallas_desc


@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_laplacian_2d_matches_dense(variant):
    n_int = 10
    nf = n_int + 2
    dx = 0.25
    u = _field((nf, nf), 2)
    if variant == "reference":
        L = ref.build_laplacian_noflux(n_int, n_int, dx, dx)
    else:
        # exact no-flux operator: unit couplings, diagonal -(neighbours)
        L = ref.build_laplacian_noflux(n_int, n_int, 1.0, 1.0)
        np.fill_diagonal(L, 0.0)
        np.fill_diagonal(L, -L.sum(axis=1))
        L = L / (dx * dx)
    lt = tops.laplacian_2d((nf, nf), dx, dx, variant=variant,
                           dtype=torch.float64)
    got = lt(torch.from_numpy(u)).numpy().reshape(-1)
    assert _rel(got, L @ u.reshape(-1)) <= TOL


@pytest.mark.parametrize("dim", [-1, -2])
def test_neighbor_sum_matches_jax(dim):
    u = _field((3, 7, 5), 3)
    want = np.asarray(jops.neighbor_sum(jnp.asarray(u), dim))
    got = tops.neighbor_sum(torch.from_numpy(u), dim).numpy()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shape", [(7, 7), (2, 6, 9)])
def test_neumann_no_velocity_2d(shape):
    u = _field(shape, 4)
    # numpy port of boundaries.hpp:41-57, corner order kept
    want = u.copy()
    want[..., 0, 1:-1] = want[..., 1, 1:-1]
    want[..., -1, 1:-1] = want[..., -2, 1:-1]
    want[..., :, 0] = want[..., :, 1]
    want[..., :, -1] = want[..., :, -2]
    ut = torch.from_numpy(u.copy())
    got = tbc.neumann_no_velocity_2d(ut).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jbc.neumann_no_velocity_2d(jnp.asarray(u))))
    np.testing.assert_array_equal(ut.numpy(), u)     # input left unchanged
