"""Port operators and boundaries vs the JAX package and dense matrices.

Same seeded numpy inputs through nlsolvers_tpu and nlsolvers_tpu_torch in
float64 on the CPU. Tolerance rel <= 1e-12: the arithmetic is the same
elementwise sequence, so only the last bits may differ. The ghost copies are
copies, so they must agree bit for bit. The 3D operators run at a ragged
(6, 7, 9) grid and at (8, 16, 128), the layout of the TPU kernels.
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
                           dtype=torch.float64, device="cpu")
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
                           dtype=torch.float64, device="cpu")
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


SHAPES_3D = [(6, 7, 9), (8, 16, 128)]


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_laplacian_3d_matches_jax(shape, variant):
    u = _field((2,) + shape, 5)                  # with a batch axis
    lj = jops.laplacian_3d(shape, 0.3, variant=variant, dtype=jnp.float64)
    lt = tops.laplacian_3d(shape, 0.3, variant=variant, dtype=torch.float64,
                           device="cpu")
    want = np.asarray(lj(jnp.asarray(u)))
    got = lt(torch.from_numpy(u)).numpy()
    assert _rel(got, want) <= TOL
    assert lt.kernel_desc == lj._pallas_desc


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_anisotropic_laplacian_3d_matches_jax(shape, variant):
    c = 1.0 + 0.4 * np.random.default_rng(7).random(shape)
    u = _field(shape, 6)
    lj = jops.anisotropic_laplacian_3d(c, 0.3, variant=variant)
    lt = tops.anisotropic_laplacian_3d(c, 0.3, variant=variant, device="cpu")
    want = np.asarray(lj(jnp.asarray(u)))
    got = lt(torch.from_numpy(u)).numpy()
    assert _rel(got, want) <= TOL
    dj, dt = lj._pallas_desc, lt.kernel_desc
    assert dj.keys() == dt.keys()
    for k, v in dj.items():
        if k in ("wx", "wy", "wz"):
            assert dt[k].dtype == torch.float32
            np.testing.assert_array_equal(dt[k].numpy(), v)
        else:
            assert dt[k] == v


@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "aniso"])
def test_laplacian_3d_matches_dense(aniso):
    """The reference variants against the dense builders of the reference
    (tests/reference_ops.py), y-seam included."""
    n_int, dx = 4, 0.2
    nf = n_int + 2
    u = _field((nf, nf, nf), 8)
    if aniso:
        c = np.random.default_rng(9).uniform(0.5, 2.0, nf ** 3)
        L = ref.build_anisotropic_laplacian_noflux_3d(n_int, dx, c)
        lt = tops.anisotropic_laplacian_3d(c.reshape(nf, nf, nf), dx,
                                           device="cpu")
    else:
        L = ref.build_laplacian_noflux_3d(n_int, n_int, n_int, dx)
        lt = tops.laplacian_3d((nf, nf, nf), dx, dtype=torch.float64,
                               device="cpu")
    got = lt(torch.from_numpy(u)).numpy().reshape(-1)
    assert _rel(got, L @ u.reshape(-1)) <= TOL


@pytest.mark.parametrize("shape", [(5, 6, 7), (2, 4, 5, 6)])
def test_neumann_no_velocity_3d(shape):
    """Bit-identical to JAX, whose order (x faces on interior y, z; y faces
    on interior z; z faces) decides the edges and corners."""
    u = _field(shape, 10)
    ut = torch.from_numpy(u.copy())
    got = tbc.neumann_no_velocity_3d(ut).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbc.neumann_no_velocity_3d(jnp.asarray(u))))
    np.testing.assert_array_equal(ut.numpy(), u)     # input left unchanged
