"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py

Without a CUDA device every test skips (the kernels have no CPU mode; their
plain versions are held against JAX in tests/test_torch_lanczos2d.py and
tests/test_torch_lanczos3d.py).
Tolerances: fields rel-L2 <= 1e-5 (same elementwise arithmetic up to FMA
contraction); reductions |got - want| <= 1e-4 * ||a|| ||b|| (summation order
differs).
"""

import numpy as np
import pytest
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import bc3d as tb
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3

FIELD_TOL, DOT_TOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _desc(ny, nx, variant):
    return tl.matvec_descriptor("laplacian_2d", (ny, nx), 1.0 / 0.02 ** 2,
                                variant=variant)


def _kernel_and_plain(call):
    got = call()
    config.kernel_mode = "off"
    try:
        want = call()
    finally:
        config.kernel_mode = "auto"
    return got, want


def _check(got, want, fields):
    """Fields by rel-L2; each dot <a, b> against ||a|| ||b||, bounded by the
    largest squared norm among the fields involved."""
    scale = max(float(f.norm()) ** 2
                for f in list(fields) + [x for x in want if x.dim() == 3])
    for a, b in zip(got, want):
        if a.dim() == 3:
            assert _rel(a, b) <= FIELD_TOL
        else:
            assert float((a - b).abs().max()) <= DOT_TOL * scale


@pytest.mark.parametrize("shape,variant,P", [((64, 64), "reference", 2),
                                             ((37, 131), "clean", 2),
                                             ((19, 300), "reference", 1)])
def test_kernels_match_plain_on_card(cuda, shape, variant, P):
    ny, nx = shape
    desc = _desc(ny, nx, variant)
    rng = np.random.default_rng(50)
    u, av, *W = [torch.from_numpy(
        rng.standard_normal((P, ny, nx)).astype(np.float32)).to(cuda)
        for _ in range(6)]
    scal = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (5, 2)).astype(np.float32)).to(cuda)
    q = scal[None, :4].contiguous()
    calls = [lambda: tl.pass1_iso2d(scal[:1].contiguous(), u, W[:2], desc),
             lambda: tl.pipe_iso2d(scal, av, W, desc, False),
             lambda: tl.pipe_iso2d(scal, av, W, desc, True),
             lambda: tl.combine(q, W)]
    before = tl.pipe_iso2d.launches
    for call in calls:
        _check(*_kernel_and_plain(call), [u, av, *W])
    assert tl.pipe_iso2d.launches == before + 2


def test_wrapper_rejects_bad_input(cuda):
    desc = _desc(16, 16, "reference")
    u = torch.zeros((2, 16, 16), device=cuda)
    one = torch.eye(1, 2, device=cuda)
    with pytest.raises(TypeError):
        tl.pass1_iso2d(one, u.double(), [], desc)
    with pytest.raises(ValueError):
        tl.pass1_iso2d(one, u, [u[:, :8]], desc)
    with pytest.raises(ValueError):
        tl.pass1_iso2d(one, u.transpose(1, 2), [], desc)


def _desc3d(shape, mode, cuda):
    dx = 2.0 * 5.0 / (shape[-1] - 1)
    if mode == "aniso":
        c = 1.0 + 0.4 * np.random.default_rng(5).random(shape)
        return tops.anisotropic_laplacian_3d(c, dx, device=cuda).kernel_desc
    return tops.laplacian_3d(shape, dx, variant=mode, device=cuda).kernel_desc


@pytest.mark.parametrize("shape,mode,j", [
    ((37, 50, 61), "reference", 0), ((37, 50, 61), "clean", 4),
    ((37, 50, 61), "aniso", 8), ((3, 4, 130), "reference", tl.MAX_M - 2),
    ((9, 11, 13), "clean", tl.MAX_M - 2), ((5, 7, 33), "aniso", tl.MAX_M - 2)])
def test_3d_kernels_match_plain_on_card(cuda, shape, mode, j):
    """pass1_3d and pass2 on ragged grids up to j = MAX_M - 2 columns, and
    the in-place ghost copy, which must equal its plain version exactly."""
    nz, ny, nx = shape
    desc = _desc3d(shape, mode, cuda)
    rng = np.random.default_rng(60 + j)
    w, *W = [torch.from_numpy(
        rng.standard_normal((2, nz * ny, nx)).astype(np.float32)).to(cuda)
        for _ in range(j + 2)]
    scal = torch.tensor([[0.7, 0.3]], device=cuda)
    q = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (j + 1, 2)).astype(np.float32)).to(cuda)
    before = (t3.pass1_3d.launches, t3.pass2.launches,
              tb.neumann_bc_planar_3d.launches)
    for call in (lambda: t3.pass1_3d(scal, W[j], W[:j], desc),
                 lambda: t3.pass2(q, w, W)):
        _check(*_kernel_and_plain(call), [w, *W])
    got, want = _kernel_and_plain(
        lambda: tb.neumann_bc_planar_3d(w.clone(), shape))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (t3.pass1_3d.launches, t3.pass2.launches,
            tb.neumann_bc_planar_3d.launches) == tuple(b + 1 for b in before)


def test_3d_wrappers_reject_bad_input(cuda):
    shape = (4, 5, 6)
    desc = _desc3d(shape, "reference", cuda)
    u = torch.zeros((2, 20, 6), device=cuda)
    one = torch.eye(1, 2, device=cuda)
    with pytest.raises(TypeError):
        t3.pass1_3d(one, u.double(), [], desc)
    with pytest.raises(ValueError):
        t3.pass1_3d(one, u.reshape(2, 10, 12).contiguous(), [], desc)
    with pytest.raises(ValueError):
        t3.pass2(torch.zeros((2, 2), device=cuda), u, [u])
    with pytest.raises(ValueError):
        tb.neumann_bc_planar_3d(u.double(), shape)
