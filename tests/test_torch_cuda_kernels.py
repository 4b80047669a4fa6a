"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py

Without a CUDA device every test skips (the kernels have no CPU mode; their
plain versions are held against JAX in tests/test_torch_lanczos2d.py and
tests/test_torch_lanczos3d.py). The 2D kernels are checked with both
operators: the 5-point Laplacian (K1, K2) and div(c grad u) (K1', K2').
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
from nlsolvers_tpu_torch.ops.cuda import kick as tk
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
                                             ((19, 300), "reference", 1),
                                             ((251, 335), "clean", 2),
                                             ((250, 334), "reference", 1),
                                             ((1024, 1024), "reference", 2),
                                             ((3, 3), "clean", 2)])
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
             lambda: tl.pass1_iso2d(scal[:1].contiguous(), u, [], desc),
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


def _desc_aniso(ny, nx, cuda):
    c = 1.0 + 0.4 * np.random.default_rng(7).random((ny, nx))
    return tops.anisotropic_laplacian_2d(c, 0.02, 0.02,
                                         device=cuda).kernel_desc


@pytest.mark.parametrize("shape,P,j", [((64, 64), 2, 0), ((37, 131), 2, 4),
                                       ((19, 300), 1, 8),
                                       ((250, 333), 2, tl.MAX_M - 2),
                                       ((5, 3), 2, 18), ((3, 129), 1, 12)])
def test_aniso2d_kernels_match_plain_on_card(cuda, shape, P, j):
    """K1' and K2' (every bucket up to j = MAX_M - 2, the last iteration
    too) on ragged grids against their plain versions; each wrapper counts
    only its own launches."""
    ny, nx = shape
    desc = _desc_aniso(ny, nx, cuda)
    rng = np.random.default_rng(80 + j)
    av, *W = [torch.from_numpy(
        rng.standard_normal((P, ny, nx)).astype(np.float32)).to(cuda)
        for _ in range(j + 2)]
    scal = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (j + 2, 2)).astype(np.float32)).to(cuda)
    counters = (tl.pass1_iso2d, tl.pass1_aniso2d, tl.pipe_iso2d,
                tl.pipe_aniso2d)
    before = [f.launches for f in counters]
    for call in (lambda: tl.pass1_aniso2d(scal[:1].contiguous(), W[j], W[:j],
                                          desc),
                 lambda: tl.pipe_aniso2d(scal, av, W, desc, False),
                 lambda: tl.pipe_aniso2d(scal, av, W, desc, True)):
        _check(*_kernel_and_plain(call), [av, *W])
    assert [f.launches for f in counters] == [before[0], before[1] + 1,
                                              before[2], before[3] + 2]


def test_aniso2d_wrappers_reject_bad_input(cuda):
    desc = _desc_aniso(16, 16, cuda)
    u = torch.zeros((2, 16, 16), device=cuda)
    one = torch.eye(1, 2, device=cuda)
    scal = torch.zeros((2, 2), device=cuda)
    with pytest.raises(TypeError):
        tl.pass1_aniso2d(one, u.double(), [], desc)
    with pytest.raises(ValueError):          # weights on another device
        tl.pass1_aniso2d(one, u, [], dict(desc, wx=desc["wx"].cpu()))
    with pytest.raises(ValueError):          # weights of another grid
        tl.pipe_aniso2d(scal, u[:, :8].contiguous(), [u[:, :8].contiguous()],
                        desc, False)
    with pytest.raises(ValueError):
        tl.pipe_aniso2d(scal, u, [u], dict(desc, wy=desc["wy"].double()),
                        False)


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


# ------------------------------------------------ K5, K8, K13 (opt-in paths)

def _fields_on(cuda, k, shape, P, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((P,) + shape).astype(
        np.float32)).to(cuda) for _ in range(k)]


def _iter_descs(mode, cuda):
    """(descriptor, field rows, nx) of each operator K5 takes, on ragged
    grids."""
    if mode in ("reference", "clean"):
        return _desc(37, 131, mode), 37, 131
    if mode == "aniso2d":
        return _desc_aniso(19, 300, cuda), 19, 300
    shape = (9, 11, 13)
    return _desc3d(shape, mode[:-2], cuda), 99, 13


# (mode, P, j, form): every operator, both field kinds, every bucket up to
# j = MAX_M - 2; the form of w by iter_plan's rule ("plan"), forced global
# (on the most blocks a launch takes) or forced on chip on 7 blocks (each
# block then owns rows of several strips); the 16-byte form (nx % 4 == 0,
# 3D 9x11x16) and the scalar one
_ITER_CASES = [("reference", 2, 0, "plan"), ("clean", 2, 5, "plan"),
               ("aniso2d", 2, 8, "plan"), ("aniso2d", 1, 3, "plan"),
               ("reference3d", 2, 8, "plan"), ("clean3d", 1, tl.MAX_M - 2,
                                                "plan"),
               ("reference", 2, tl.MAX_M - 2, "plan"),
               ("reference", 2, 4, "global"), ("aniso2d", 2, 12, "global"),
               ("clean3d", 2, 17, "global"), ("reference3d", 1, 2, "global"),
               ("clean", 1, 9, "onchip7"), ("aniso2d", 2, 1, "onchip7"),
               ("reference3d", 2, 6, "onchip7"),
               ("reference3d16", 2, 6, "plan"), ("clean3d16", 2, 20,
                                                 "global"),
               ("reference1024", 2, 8, "plan")]


@pytest.mark.parametrize("mode,P,j,form", _ITER_CASES,
                         ids=[f"{m}-P{P}-j{j}-{f}"
                              for m, P, j, f in _ITER_CASES])
def test_iter_step_matches_plain_on_card(cuda, monkeypatch, mode, P, j,
                                         form):
    """K5 on every operator it takes, both field kinds, up to j = MAX_M - 2,
    both forms of w, against iter_ref; W_{j+1} by rel-L2, raw and nsq at
    the dot scale."""
    if mode.endswith("16"):
        desc, rows, nx = _desc3d((9, 11, 16), mode[:-4], cuda), 99, 16
    elif mode == "reference1024":
        desc, rows, nx = _desc(1024, 1024, "reference"), 1024, 1024
    else:
        desc, rows, nx = _iter_descs(mode, cuda)
    if form != "plan":
        segs = -(-nx // tl.STRIP_COLS) * rows
        grid = 7 if form == "onchip7" else min(segs,
                                               tl._lib().lz_coop_max_blocks())
        monkeypatch.setattr(tl, "iter_form",
                            lambda *a: (form == "onchip7", grid))
    W = _fields_on(cuda, j + 1, (rows, nx), P, 90 + j)
    rng = np.random.default_rng(9)
    s = rng.uniform(0.2, 1.0, j + 1).astype(np.float32)
    scal = torch.from_numpy(np.concatenate([[s[j], 0.3], s]).astype(
        np.float32)[None]).to(cuda)
    before = tl.iter_step.launches
    _check(*_kernel_and_plain(lambda: tl.iter_step(scal, W[j], W[:j], desc)),
           W)
    assert tl.iter_step.launches == before + 1


def test_iter_step_and_pass1_repeat_bit_for_bit(cuda, monkeypatch):
    """Two launches of K5 (on-chip and global w) and of K1 / K1' on the same
    inputs give the same bits: fields, raw dots and norms (fixed grid, fixed
    order of sums, no atomics)."""
    desc = _desc(1024, 1024, "reference")
    W = _fields_on(cuda, 9, (1024, 1024), 2, 160)
    s = np.random.default_rng(161).uniform(0.2, 1.0, 9).astype(np.float32)
    scal = torch.from_numpy(np.concatenate([[s[8], 0.3], s]).astype(
        np.float32)[None]).to(cuda)
    sc1 = scal[:, :2].contiguous()
    da = _desc_aniso(250, 333, cuda)
    Wa = _fields_on(cuda, 9, (250, 333), 2, 162)
    calls = [lambda: tl.iter_step(scal, W[8], W[:8], desc),
             lambda: tl.pass1_iso2d(sc1, W[8], W[:8], desc),
             lambda: tl.pass1_aniso2d(sc1, Wa[8], Wa[:8], da)]
    for call in calls:
        a, b = call(), call()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tl.iter_form(2, 1024, 1024, 0, 8, True)[0]
    grid = tl._lib().lz_coop_max_blocks()
    monkeypatch.setattr(tl, "iter_form", lambda *a: (False, grid))
    a, b = calls[0](), calls[0]()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_iter_step_rejects_bad_input(cuda):
    desc = _desc(16, 16, "reference")
    u = torch.zeros((2, 16, 16), device=cuda)
    scal = torch.ones((1, 3), device=cuda)
    with pytest.raises(TypeError):
        tl.iter_step(scal, u.double(), [], desc)
    with pytest.raises(ValueError):                  # scalars of another j
        tl.iter_step(torch.ones((1, 4), device=cuda), u, [], desc)
    with pytest.raises(ValueError):                  # field of another grid
        tl.iter_step(scal, u[:, :8].contiguous(), [], desc)
    with pytest.raises(ValueError):                  # no aniso3d mode
        tl.iter_step(scal, torch.zeros((2, 20, 6), device=cuda), [],
                     _desc3d((4, 5, 6), "aniso", cuda))


# (shape, mode, P, j): nx % 4 == 0 (the 16-byte form) and != 0, ny and nz
# that no brick height divides, nx > 128 (halo columns), planes of 3 rows
# (the y-seam rows cross bricks), every bucket up to j = MAX_M - 2
_PIPE3D_CASES = [
    ((37, 50, 61), "reference", 2, 0), ((37, 50, 61), "clean", 2, 4),
    ((37, 50, 61), "aniso", 2, 8), ((20, 30, 50), "reference", 1, 6),
    ((3, 9, 130), "aniso", 1, 12), ((17, 3, 33), "reference", 2,
                                    tl.MAX_M - 2),
    ((21, 23, 64), "aniso", 2, 12), ((21, 23, 64), "clean", 1, 18),
    ((9, 31, 260), "reference", 2, 5), ((9, 31, 260), "aniso", 1, 2),
    ((33, 17, 132), "clean", 2, 18), ((33, 17, 132), "aniso", 2, 3)]


@pytest.mark.parametrize("shape,mode,P,j", _PIPE3D_CASES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{m}-P{P}-j{j}"
                              for s, m, P, j in _PIPE3D_CASES])
def test_pipe_3d_matches_plain_on_card(cuda, shape, mode, P, j):
    """K8 on ragged grids (tiles cut in x, y and z, planes of 3 rows, so
    the y-seam rows cross tiles), every operator, both field kinds."""
    nz, ny, nx = shape
    desc = _desc3d(shape, mode, cuda)
    av, *W = _fields_on(cuda, j + 2, (nz * ny, nx), P, 70 + j)
    scal = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.5, 0.5, (j + 2, 2)).astype(np.float32)).to(cuda)
    before = (t3.pipe_3d.launches, tl.pipe_iso2d.launches)
    _check(*_kernel_and_plain(lambda: t3.pipe_3d(scal, av, W, desc)),
           [av, *W])
    assert (t3.pipe_3d.launches, tl.pipe_iso2d.launches) == (
        before[0] + 1, before[1])


def test_pipe_3d_rejects_bad_input(cuda):
    desc = _desc3d((4, 5, 6), "aniso", cuda)
    u = torch.zeros((2, 20, 6), device=cuda)
    scal = torch.zeros((2, 2), device=cuda)
    with pytest.raises(TypeError):
        t3.pipe_3d(scal, u.double(), [u.double()], desc)
    with pytest.raises(ValueError):                  # not the merged view
        t3.pipe_3d(scal, u.reshape(2, 10, 12).contiguous(),
                   [u.reshape(2, 10, 12).contiguous()], desc)
    with pytest.raises(ValueError):                  # weights on the CPU
        t3.pipe_3d(scal, u, [u], dict(desc, wz=desc["wz"].cpu()))


# (shape, kind, variant, m, bc): every density, both variants, with and
# without the ghost ring, m from 1 to 20 (every bucket of the dots), nx %
# 4 == 0 (the 16-byte form; 200 x 256 and 130 x 260 over several tiles)
# and != 0
_RESIDENT_CASES = [
    ((64, 64), "cubic", "reference", 10, True),
    ((37, 131), "cubic_quintic", "clean", 8, True),
    ((250, 333), "saturable", "reference", 20, False),
    ((5, 3), "cubic", "clean", 1, True),
    ((200, 256), "cubic", "clean", 20, False),
    ((130, 260), "saturable", "clean", 10, True),
    ((97, 333), "cubic_quintic", "reference", 20, True),
    ((64, 64), "cubic", "reference", 2, False),
    ((3, 129), "saturable", "reference", 3, True),
    ((1024, 1024), "cubic", "reference", 10, True)]


@pytest.mark.parametrize("shape,kind,variant,m,bc", _RESIDENT_CASES,
                         ids=[f"{s[0]}x{s[1]}-{k}-{v}-m{m}{'-bc' * b}"
                              for s, k, v, m, b in _RESIDENT_CASES])
def test_resident_step_matches_plain_on_card(cuda, shape, kind, variant, m,
                                             bc):
    """K13, one whole step, against ss2_resident_step_ref; one launch per
    step, and a second step through the same scratch."""
    from nlsolvers_tpu_torch.ops.cuda import resident2d as r2
    ny, nx = shape
    dx = 2.0 * 5.0 / (nx - 1)
    desc = tops.laplacian_2d(shape, dx, dx, variant=variant,
                             device=cuda).kernel_desc
    (u,) = _fields_on(cuda, 1, shape, 2, 11)
    mf = torch.from_numpy((1.0 + 0.2 * np.random.default_rng(2).random(
        shape)).astype(np.float32)).to(cuda)
    dt = 2.0 / (8.0 * desc["scale"])                 # theta = 2
    scratch = {}
    before = r2.ss2_resident_step.launches
    for _ in range(2):
        got, want = _kernel_and_plain(lambda: r2.ss2_resident_step(
            u, mf, desc, dt, m, kind=kind, apply_bc=bc, scratch=scratch))
        assert _rel(got, want) <= FIELD_TOL
        u = got
    assert r2.ss2_resident_step.launches == before + 2


def test_resident_step_rejects_bad_input(cuda):
    from nlsolvers_tpu_torch.ops.cuda import resident2d as r2
    desc = _desc(16, 16, "reference")
    u = torch.zeros((2, 16, 16), device=cuda)
    mf = torch.ones((16, 16), device=cuda)
    dt = 0.25 / desc["scale"]                        # theta = 2
    with pytest.raises(ValueError):
        r2.ss2_resident_step(u.double(), mf, desc, dt, 8)
    with pytest.raises(ValueError):
        r2.ss2_resident_step(u, mf.cpu(), desc, dt, 8)
    with pytest.raises(ValueError):                  # theta = 4 > 3.5
        r2.ss2_resident_step(u, mf, desc, 2 * dt, 8)
    with pytest.raises(ValueError):
        r2.ss2_resident_step(u, mf, desc, dt, tl.MAX_M + 1)


# ------------------------------------------------ shard kernels (sharded step)

def _rand(cuda, rng, *shape, lo=None):
    a = (rng.standard_normal(shape) if lo is None
         else lo + 0.4 * rng.random(shape))
    return torch.from_numpy(a.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("mode,shape,P,j", [
    ("reference", (64, 64), 2, 0), ("clean", (37, 131), 1, 3),
    ("aniso", (37, 131), 2, 3), ("aniso", (2, 2), 2, tl.MAX_M - 2),
    ("reference", (19, 300), 2, 18)])
def test_pass1_shard2d_matches_plain_on_card(cuda, mode, shape, P, j):
    """K1' in the shard modes on ragged blocks with random halos and face
    weights, at an interior place of a larger grid."""
    ny, nx = shape
    rng = np.random.default_rng(90 + j)
    W = [_rand(cuda, rng, P, ny, nx) for _ in range(j + 1)]
    yh, xh = _rand(cuda, rng, P, 2, nx), _rand(cuda, rng, P, 2, ny)
    d = dict(kind="shard2d" if mode != "aniso" else "shard2d_aniso",
             NY=3 * ny, NX=3 * nx, y0=ny, x0=0, scale=1.0 / 0.02 ** 2,
             sign=-1.0 if P == 1 else 1.0, variant=mode)
    if mode == "aniso":
        d.update(wx=_rand(cuda, rng, ny, nx, lo=1.0),
                 wy=_rand(cuda, rng, ny, nx, lo=1.0),
                 wxl=_rand(cuda, rng, ny, lo=1.0),
                 wyh=_rand(cuda, rng, nx, lo=1.0))
    scal = torch.tensor([[0.7, 0.3]], device=cuda)
    before = tl.pass1_shard2d.launches
    _check(*_kernel_and_plain(
        lambda: tl.pass1_shard2d(scal, W[j], W[:j], yh, xh, d)), W)
    assert tl.pass1_shard2d.launches == before + 1


@pytest.mark.parametrize("mode,shape,P,j", [
    ("reference", (6, 9, 70), 2, 0), ("clean", (5, 9, 70), 2, 4),
    ("aniso", (5, 9, 70), 1, 3), ("clean", (2, 2, 2), 2, tl.MAX_M - 2),
    ("aniso", (4, 3, 129), 2, 18)])
def test_pass1_shard3d_matches_plain_on_card(cuda, mode, shape, P, j):
    """pass1_shard3d in each mode on ragged blocks with random halos."""
    nz, ny, nx = shape
    R = nz * ny
    rng = np.random.default_rng(95 + j)
    W = [_rand(cuda, rng, P, R, nx) for _ in range(j + 1)]
    yh, zh = _rand(cuda, rng, P, 2, nz, nx), _rand(cuda, rng, P, 2, ny, nx)
    xh = _rand(cuda, rng, P, 2, R)
    d = dict(kind="shard3d" if mode != "aniso" else "shard3d_aniso",
             NZ=2 * nz, NY=ny, NX=3 * nx, z0=nz, y0=0, x0=nx, lnz=nz, lny=ny,
             scale=1.0 / 0.02 ** 2, sign=1.0, variant=mode)
    if mode == "aniso":
        d.update(wx=_rand(cuda, rng, R, nx, lo=1.0),
                 wy=_rand(cuda, rng, R, nx, lo=1.0),
                 wz=_rand(cuda, rng, R, nx, lo=1.0),
                 wxl=_rand(cuda, rng, R, lo=1.0),
                 wyh=_rand(cuda, rng, nz, nx, lo=1.0),
                 wzh=_rand(cuda, rng, ny, nx, lo=1.0))
    scal = torch.tensor([[0.7, 0.3]], device=cuda)
    before = t3.pass1_shard3d.launches
    _check(*_kernel_and_plain(
        lambda: t3.pass1_shard3d(scal, W[j], W[:j], yh, zh, xh, d)), W)
    assert t3.pass1_shard3d.launches == before + 1


@pytest.mark.parametrize("offsets,launch", [((0, 0, 0), 1), ((4, 3, 0), 1),
                                            ((2, 3, 7), 0), ((4, 6, 14), 1)])
def test_bc3d_offsets_match_plain_on_card(cuda, offsets, launch):
    """The ghost copy on a (4, 3, 7) block of an (8, 9, 21) grid equals its
    plain version exactly; a block with no face launches nothing."""
    shape, glob = (4, 3, 7), (8, 9, 21)
    u = _rand(cuda, np.random.default_rng(3), 2, 12, 7)
    before = tb.neumann_bc_planar_3d.launches
    got, want = _kernel_and_plain(lambda: tb.neumann_bc_planar_3d(
        u.clone(), shape, glob, offsets))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tb.neumann_bc_planar_3d.launches == before + launch


def test_shard_wrappers_reject_bad_input(cuda):
    u = torch.zeros((2, 8, 8), device=cuda)
    one = torch.eye(1, 2, device=cuda)
    d = dict(kind="shard2d", NY=16, NX=16, y0=0, x0=0, scale=1.0, sign=1.0,
             variant="reference")
    yh = torch.zeros((2, 2, 8), device=cuda)
    with pytest.raises(ValueError):          # halo of another block
        tl.pass1_shard2d(one, u, [], yh[:, :, :4].contiguous(), yh, d)
    with pytest.raises(ValueError):          # halo on another device
        tl.pass1_shard2d(one, u, [], yh.cpu(), yh, d)
    d3 = dict(kind="shard3d", NZ=4, NY=4, NX=8, z0=0, y0=0, x0=0, lnz=2,
              lny=4, scale=1.0, sign=1.0, variant="clean")
    with pytest.raises(ValueError):          # not the merged view
        t3.pass1_shard3d(one, u, [], torch.zeros((2, 2, 2, 8), device=cuda),
                         torch.zeros((2, 2, 4, 8), device=cuda),
                         torch.zeros((2, 2, 8), device=cuda),
                         dict(d3, lny=3))
    with pytest.raises(ValueError):          # a block outside the grid
        tb.neumann_bc_planar_3d(u, (2, 4, 8), (4, 4, 8), (3, 0, 0))


@pytest.mark.parametrize("shape,mshape,variant,use_c", [
    ((24, 40), (2, 2), "reference", False), ((24, 40), (2, 2), "clean", True),
    ((8, 12, 16), (2, 2, 2), "clean", False),
    ((8, 12, 16), (2, 2, 2), "clean", True),
    ((8, 12, 16), (1, 1, 4), "reference", True)])
def test_sharded_step_on_card(cuda, shape, mshape, variant, use_c):
    """The sharded SS2 step on a mesh of shards on one card: kernels
    against plain versions (rel-L2 <= 1e-5), and the exact launches per
    step: per shard m-1 shard pass1 and pass2, 1 combine and 2 kick_bc (the
    closing one with the ghost copy, so no bc3d); no unsharded pass1."""
    from nlsolvers_tpu_torch.parallel import mesh as tmesh
    from nlsolvers_tpu_torch.parallel import shards, spatial

    axes = ("gy", "gx") if len(shape) == 2 else ("gz", "gy", "gx")
    n = int(np.prod(mshape))
    mesh = tmesh.make_mesh(axes, mshape, devices=[cuda] * n)
    rng = np.random.default_rng(12)
    u0 = 0.1 * rng.standard_normal((2,) + shape).astype(np.float32)
    args = [u0, np.ones(shape, np.float32)]
    if use_c:
        args.append((1.0 + 0.4 * rng.random(shape)).astype(np.float32))
    m = 6
    step = spatial.make_sharded_nlse_step("cubic", shape, 5.0, 1e-3, mesh,
                                          axis_names=axes, krylov_m=m,
                                          variant=variant, use_c=use_c)
    parts = [shards.shard(a, mesh) for a in args]
    pass1 = tl.pass1_shard2d if len(shape) == 2 else t3.pass1_shard3d
    counters = (pass1, t3.pass2, tl.combine, tb.neumann_bc_planar_3d,
                tk.phase_kick_bc_planar, tl.pass1_iso2d, tl.pass1_aniso2d,
                t3.pass1_3d)
    before = [f.launches for f in counters]
    got, want = _kernel_and_plain(lambda: shards.gather(step(*parts), mesh))
    per = [m - 1, m, 1, 0, 2, 0, 0, 0]
    assert [f.launches - b for f, b in zip(counters, before)] == [
        n * k for k in per]
    assert _rel(got, want) <= FIELD_TOL


def _shard_lanes(cuda, rng, mode, shape, P, B):
    """B lanes of a shard block: the (yh, xh) or (yh, zh, xh) halos with a
    leading B, the descriptor of the batch (face weights per lane) and each
    lane's own; the block at an interior place of a larger grid."""
    three_d = len(shape) == 3
    if three_d:
        nz, ny, nx = shape
        R = nz * ny
        halos = [_rand(cuda, rng, B, P, 2, nz, nx),
                 _rand(cuda, rng, B, P, 2, ny, nx),
                 _rand(cuda, rng, B, P, 2, R)]
        d = dict(kind="shard3d" if mode != "aniso" else "shard3d_aniso",
                 NZ=2 * nz, NY=ny, NX=3 * nx, z0=nz, y0=0, x0=nx, lnz=nz,
                 lny=ny, variant=mode)
        wshapes = (("wx", (R, nx)), ("wy", (R, nx)), ("wz", (R, nx)),
                   ("wxl", (R,)), ("wyh", (nz, nx)), ("wzh", (ny, nx)))
    else:
        ny, nx = shape
        halos = [_rand(cuda, rng, B, P, 2, nx), _rand(cuda, rng, B, P, 2, ny)]
        d = dict(kind="shard2d" if mode != "aniso" else "shard2d_aniso",
                 NY=3 * ny, NX=3 * nx, y0=ny, x0=nx, variant=mode)
        wshapes = (("wx", (ny, nx)), ("wy", (ny, nx)), ("wxl", (ny,)),
                   ("wyh", (nx,)))
    d.update(scale=1.0 / 0.02 ** 2, sign=-1.0 if P == 1 else 1.0)
    if mode == "aniso":
        d.update({k: _rand(cuda, rng, B, *shp, lo=1.0) for k, shp in wshapes})
    lanes = [dict(d, **{k: d[k][b] for k, _ in wshapes})
             if mode == "aniso" else d for b in range(B)]
    return halos, d, lanes


@pytest.mark.parametrize("mode,shape,P", [
    ("reference", (64, 64), 2), ("clean", (37, 131), 1),
    ("aniso", (37, 131), 2), ("aniso", (2, 2), 1), ("aniso", (64, 64), 1),
    ("reference", (6, 9, 70), 2), ("clean", (5, 9, 70), 1),
    ("aniso", (5, 9, 70), 2), ("aniso", (2, 2, 2), 1),
    ("clean", (4, 3, 129), 2)])
def test_batched_shard_kernels_bit_equal_to_lane_launches_on_card(
        cuda, mode, shape, P):
    """pass1_shard2d / pass1_shard3d on B = 3 lanes of a shard block, each
    lane with its own halos (and face weights), j = 0, 4 and 18: ONE
    launch, lane b bit-equal to the unbatched launch on lane b and within
    the gates of the plain batched version; two launches bit for bit."""
    B = 3
    rng = np.random.default_rng(300 + P + len(shape))
    halos, d, lanes = _shard_lanes(cuda, rng, mode, shape, P, B)
    three_d = len(shape) == 3
    kern = t3.pass1_shard3d if three_d else tl.pass1_shard2d
    rows = shape[0] * shape[1] if three_d else shape[0]
    W = [_rand(cuda, rng, B, P, rows, shape[-1]) for _ in range(19)]
    for j in (0, 4, 18):
        scal = torch.from_numpy(rng.uniform(0.2, 1.0, (B, 1, 2)).astype(
            np.float32)).to(cuda)
        before = kern.launches
        got, want = _kernel_and_plain(
            lambda: kern(scal, W[j], W[:j], *halos, d))
        assert kern.launches == before + 1
        _batch_check(got, want, W[:j + 1] + [want[0]])
        _lane_equal(got, [kern(scal[b], W[j][b], [w[b] for w in W[:j]],
                               *[h[b] for h in halos], lanes[b])
                          for b in range(B)])
        again = kern(scal, W[j], W[:j], *halos, d)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


# pass1_shard3d's bricks: widths whose tiles are 4 (nx = 2) and 64 columns
# wide (50: ragged, not a multiple of 4, the scalar form; 64 and 256: the
# 16-byte form, 256 in four tiles); blocks of 2 x 2 and of 9 x 19 (two y
# tiles, the second ragged, and bricks marching up and down in z); the block
# at a corner of the grid (every halo at the domain's edge) or inside it
_SHARD3D_NX = (2, 50, 64, 256)
_SHARD3D_BLOCKS = ((2, 2), (9, 19))
_SHARD3D_J = (0, 4, 8, 9, 18)


def _shard3d_case(cuda, rng, mode, nz, ny, nx, P, B, corner):
    """B lanes of an (nz, ny, nx) block (B = 0: one lane without the lane
    axis): halos, the descriptor (face weights per lane) and 19 columns."""
    lead = (B,) if B else ()
    R = nz * ny
    halos = [_rand(cuda, rng, *lead, P, 2, nz, nx),
             _rand(cuda, rng, *lead, P, 2, ny, nx),
             _rand(cuda, rng, *lead, P, 2, R)]
    ref = mode == "reference"           # z and y whole under the reference
    d = dict(kind="shard3d" if mode != "aniso" else "shard3d_aniso",
             NZ=nz if ref else 3 * nz, NY=ny if ref else 3 * ny, NX=3 * nx,
             z0=0 if corner or ref else nz, y0=0 if corner or ref else ny,
             x0=0 if corner else nx, lnz=nz, lny=ny, scale=1.0 / 0.02 ** 2,
             sign=-1.0 if P == 1 else 1.0, variant=mode)
    if mode == "aniso":
        d.update({k: _rand(cuda, rng, *lead, *shp, lo=1.0) for k, shp in (
            ("wx", (R, nx)), ("wy", (R, nx)), ("wz", (R, nx)), ("wxl", (R,)),
            ("wyh", (nz, nx)), ("wzh", (ny, nx)))})
    W = [_rand(cuda, rng, *lead, P, R, nx) for _ in range(19)]
    return halos, d, W


@pytest.mark.parametrize("corner", [True, False])
@pytest.mark.parametrize("block", _SHARD3D_BLOCKS)
@pytest.mark.parametrize("nx", _SHARD3D_NX)
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
def test_pass1_shard3d_bricks_match_plain_on_card(cuda, mode, P, nx, block,
                                                  corner):
    """The brick kernel of pass1_shard3d at every width class, on small and
    ragged blocks at a corner and inside the grid, at j = 0, 4, 8, 9 and 18
    (every bucket edge): within the gates of pass1_shard3d_ref, one launch
    each."""
    nz, ny = block
    rng = np.random.default_rng(1000 + nx + 7 * P + ny)
    halos, d, W = _shard3d_case(cuda, rng, mode, nz, ny, nx, P, 0, corner)
    for j in _SHARD3D_J:
        scal = torch.tensor([[0.7, 0.3]], device=cuda)
        before = t3.pass1_shard3d.launches
        _check(*_kernel_and_plain(
            lambda: t3.pass1_shard3d(scal, W[j], W[:j], *halos, d)),
            W[:j + 1])
        assert t3.pass1_shard3d.launches == before + 1


@pytest.mark.parametrize("nx", _SHARD3D_NX)
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
def test_pass1_shard3d_three_lanes_bit_equal_to_one_on_card(cuda, mode, P,
                                                            nx):
    """B = 3 lanes of a 9 x 19 x nx block inside the grid in ONE launch at
    j = 0, 4, 8, 9 and 18: lane b bit-equal to the launch on lane b alone
    (B = 1, no lane axis) and within the gates of the plain batched
    version."""
    B = 3
    rng = np.random.default_rng(2000 + nx + P)
    halos, d, W = _shard3d_case(cuda, rng, mode, 9, 19, nx, P, B, False)
    wkeys = [k for k in d if k.startswith("w")]
    lanes = [dict(d, **{k: d[k][b] for k in wkeys}) for b in range(B)]
    for j in _SHARD3D_J:
        scal = torch.from_numpy(rng.uniform(0.2, 1.0, (B, 1, 2)).astype(
            np.float32)).to(cuda)
        got, want = _kernel_and_plain(
            lambda: t3.pass1_shard3d(scal, W[j], W[:j], *halos, d))
        _batch_check(got, want, W[:j + 1] + [want[0]])
        _lane_equal(got, [t3.pass1_shard3d(
            scal[b], W[j][b], [w[b] for w in W[:j]],
            *[h[b] for h in halos], lanes[b]) for b in range(B)])


@pytest.mark.parametrize("tiles", [dict(nxt=16, tyt=16, pz=1),
                                   dict(nxt=32, tyt=8, pz=3),
                                   dict(nxt=128, tyt=2, pz=9),
                                   dict(nxt=4, tyt=64, pz=2)])
@pytest.mark.parametrize("mode", ["clean", "aniso"])
def test_pass1_shard3d_other_bricks_match_plain_on_card(cuda, monkeypatch,
                                                        mode, tiles):
    """Bricks other than shard3d_tiles' (one plane deep, several x tiles,
    one wider than the block) give the same function; bricks the kernel
    cannot take (more than 256 threads, a width that is no power of two)
    raise."""
    rng = np.random.default_rng(77)
    halos, d, W = _shard3d_case(cuda, rng, mode, 9, 19, 64, 2, 0, False)
    scal = torch.tensor([[0.7, 0.3]], device=cuda)
    monkeypatch.setattr(t3, "shard3d_tiles", lambda *a: tiles)
    for j in (0, 9):
        _check(*_kernel_and_plain(lambda: t3.pass1_shard3d(
            scal, W[j], W[:j], *halos, d)), W[:j + 1])
    for bad in (dict(nxt=64, tyt=32, pz=4), dict(nxt=48, tyt=8, pz=4)):
        monkeypatch.setattr(t3, "shard3d_tiles", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError):
            t3.pass1_shard3d(scal, W[1], W[:1], *halos, d)


@pytest.mark.parametrize("shape,mshape,variant,integrator,per", [
    ((24, 40), (2, 2), "reference", "ss2", (5, 6, 1, 2)),
    ((24, 40), (2, 2), "aniso", "sewi", (15, 18, 3, 0)),
    ((24, 40), (2, 2), "aniso", "sewi_fused", (10, 12, 2, 0)),
    ((8, 12, 16), (1, 1, 4), "reference", "gautschi", (15, 18, 3, 0)),
    ((8, 12, 16), (2, 2, 2), "clean", "ss2", (5, 6, 1, 2))])
def test_batched_sharded_engine_lanes_on_card(cuda, shape, mshape, variant,
                                              integrator, per):
    """The sharded NLSE engine on B = 2 lanes (m = 6, c(x) per lane unless
    iso): each batched step (after the SS2 bootstrap of a two-step
    integrator) launches exactly, per shard, the shard pass1, pass2,
    combine and kick_bc counts `per`, whatever B, and lane b of every
    snapshot is bit-equal to the engine run on lane b alone."""
    from nlsolvers_tpu_torch.parallel import mesh as tmesh
    from nlsolvers_tpu_torch.parallel import spatial

    axes = ("gy", "gx") if len(shape) == 2 else ("gz", "gy", "gx")
    n = int(np.prod(mshape))
    mesh = tmesh.make_mesh(axes, mshape, devices=[cuda] * n)
    use_c = variant == "aniso" or len(shape) == 3
    rng = np.random.default_rng(13)
    B = 2
    u0 = 0.1 * rng.standard_normal((B, 2) + shape).astype(np.float32)
    mf = (1.0 + 0.1 * rng.random((B,) + shape)).astype(np.float32)
    c = (1.0 + 0.4 * rng.random((B,) + shape)).astype(np.float32)
    traj = spatial.make_sharded_nlse_trajectory_fn(
        "cubic", shape, 5.0, 1e-3, mesh, axis_names=axes,
        integrator=integrator, krylov_m=6, use_c=use_c,
        variant="clean" if variant == "aniso" else variant)
    pass1 = tl.pass1_shard2d if len(shape) == 2 else t3.pass1_shard3d
    counters = (pass1, t3.pass2, tl.combine, tk.phase_kick_bc_planar)
    traj(u0, mf, c, 2, 2)                     # the bootstrap and one step
    before = [f.launches for f in counters]
    got = traj(u0, mf, c, 2, 3)
    diff = [f.launches - b for f, b in zip(counters, before)]
    boot = (5, 6, 1, 2) if integrator != "ss2" else per
    assert diff == [n * (a + 2 * b) for a, b in zip(boot, per)]
    for b in range(B):
        alone = traj(u0[b:b + 1], mf[b:b + 1], c[b:b + 1], 2, 3)
        assert torch.equal(got[b], alone[0])


# ------------------------------------------------ K2/K2' tiles and K3 vectors

def _pipe_desc(op, ny, nx, P, cuda):
    """The operator of a K2 (iso, reference) or K2' (aniso) case; sign -1
    with a real field, as a real-wave operator runs."""
    d = _desc(ny, nx, "reference") if op == "iso" else _desc_aniso(ny, nx,
                                                                    cuda)
    return dict(d, sign=-1.0) if P == 1 else d


# (shape, j, P, last): nx % 4 in {0, 1, 2, 3} (16-byte and scalar
# instantiations; 37 x 129 and 19 x 303 also have a plane size n % 4 != 0),
# every bucket up to j = 18 (m = 20), LAST, real fields, and a grid of more
# tiles than one pass of the fixed grid
_PIPE_CASES = [((64, 64), 0, 2, False), ((64, 64), 5, 2, False),
               ((37, 129), 12, 2, False), ((50, 130), 18, 2, False),
               ((19, 303), 3, 2, False), ((64, 64), 8, 2, True),
               ((50, 130), 18, 2, True), ((37, 129), 4, 1, False),
               ((64, 64), 16, 1, True), ((2048, 4096), 2, 2, False)]


@pytest.mark.parametrize("op", ["iso", "aniso"])
@pytest.mark.parametrize("shape,j,P,last", _PIPE_CASES,
                         ids=[f"{s[0]}x{s[1]}-j{j}-P{P}{'-last' * l}"
                              for s, j, P, l in _PIPE_CASES])
def test_pipe_2d_tiles_match_plain_on_card(cuda, op, shape, j, P, last):
    ny, nx = shape
    desc = _pipe_desc(op, ny, nx, P, cuda)
    av, *W = _fields_on(cuda, j + 2, shape, P, 90 + j)
    rng = np.random.default_rng(91 + j)
    scal = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (j + 2, 2)).astype(np.float32)).to(cuda)
    fn = tl.pipe_iso2d if op == "iso" else tl.pipe_aniso2d
    before = fn.launches
    _check(*_kernel_and_plain(lambda: fn(scal, av, W, desc, last)), [av, *W])
    assert fn.launches == before + 1


# (shape, m, k, P, offset): 16-byte vectors (n % 4 == 0), scalars (n % 4
# != 0, or a column that starts 4 bytes past a 16-byte boundary), k = 1..4
# specs, real fields, and more points than one pass of the fixed grid
_COMBINE_CASES = [((64, 64), 10, 1, 2, 0), ((64, 64), 20, 2, 2, 0),
                  ((37, 129), 10, 3, 2, 0), ((250, 333), 10, 4, 2, 0),
                  ((64, 64), 10, 2, 2, 1), ((19, 303), 7, 2, 1, 0),
                  ((64, 64), 1, 1, 1, 0), ((1024, 2048), 10, 4, 2, 0)]


@pytest.mark.parametrize("shape,m,k,P,offset", _COMBINE_CASES,
                         ids=[f"{s[0]}x{s[1]}-m{m}-k{k}-P{P}-off{o}"
                              for s, m, k, P, o in _COMBINE_CASES])
def test_combine_vectors_match_plain_on_card(cuda, shape, m, k, P, offset):
    W = _fields_on(cuda, m, shape, P, 120 + m)
    if offset:
        W = [torch.cat([torch.zeros(offset, device=cuda),
                        w.reshape(-1)])[offset:].view(w.shape) for w in W]
        assert W[0].data_ptr() % 16 != 0
    rng = np.random.default_rng(121 + k)
    q = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (k, m, 2)).astype(np.float32)).to(cuda)
    before = tl.combine.launches
    got, want = _kernel_and_plain(lambda: tl.combine(q, W))
    assert len(got) == k
    for a, b in zip(got, want):
        assert _rel(a, b) <= FIELD_TOL
    assert tl.combine.launches == before + 1


@pytest.mark.parametrize("op,shape", [("iso", (1024, 1024)),
                                      ("aniso", (250, 333))])
def test_pipe_2d_and_combine_repeat_bit_for_bit(cuda, op, shape):
    """Two launches on the same inputs give the same bits: fields, norms
    and dots (fixed grid, fixed order of sums, no atomics)."""
    ny, nx = shape
    desc = _pipe_desc(op, ny, nx, 2, cuda)
    av, *W = _fields_on(cuda, 10, shape, 2, 130)
    scal = torch.from_numpy(np.random.default_rng(131).uniform(
        -0.5, 0.5, (10, 2)).astype(np.float32)).to(cuda)
    fn = tl.pipe_iso2d if op == "iso" else tl.pipe_aniso2d
    q = scal[None, :9].contiguous()
    for last in (False, True):
        a = fn(scal, av, W, desc, last)
        b = fn(scal, av, W, desc, last)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y)
               for x, y in zip(tl.combine(q, W), tl.combine(q, W)))


# K8 with bricks of 1 to 25 planes (one plane, several, all but the last
# of a ragged z, the whole z) and grids of fewer blocks than bricks (a block
# walks several, marching up and down in z), nx % 4 == 0 and != 0
@pytest.mark.parametrize("brick", [(1, 5), (4, 3), (5, 2), (7, 1), (25, 7)])
@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("nx", [132, 131])
def test_pipe_3d_bricks_match_plain_on_card(cuda, monkeypatch, brick, mode,
                                            nx):
    shape = (23, 37, nx)
    monkeypatch.setattr(t3, "pipe3d_brick", lambda *a: brick)
    monkeypatch.setattr(t3, "_brick_cache", {})
    desc = _desc3d(shape, mode, cuda)
    av, *W = _fields_on(cuda, 9, (23 * 37, nx), 2, 140)
    scal = torch.from_numpy(np.random.default_rng(141).uniform(
        -0.5, 0.5, (9, 2)).astype(np.float32)).to(cuda)
    _check(*_kernel_and_plain(lambda: t3.pipe_3d(scal, av, W, desc)),
           [av, *W])


def test_pipe_3d_and_resident_repeat_bit_for_bit(cuda):
    """Two launches of K8 and of K13 on the same inputs give the same bits
    (fixed grid, fixed order of sums, no atomics)."""
    from nlsolvers_tpu_torch.ops.cuda import resident2d as r2
    desc = _desc3d((64, 64, 128), "aniso", cuda)
    av, *W = _fields_on(cuda, 9, (64 * 64, 128), 2, 150)
    scal = torch.from_numpy(np.random.default_rng(151).uniform(
        -0.5, 0.5, (9, 2)).astype(np.float32)).to(cuda)
    a = t3.pipe_3d(scal, av, W, desc)
    b = t3.pipe_3d(scal, av, W, desc)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for shape in ((256, 256), (250, 333)):
        dx = 2.0 * 5.0 / (shape[1] - 1)
        d2 = tops.laplacian_2d(shape, dx, dx, device=cuda).kernel_desc
        (u,) = _fields_on(cuda, 1, shape, 2, 152)
        mf = torch.ones(shape, device=cuda)
        dt = 2.0 / (8.0 * d2["scale"])
        sc = {}
        assert torch.equal(r2.ss2_resident_step(u, mf, d2, dt, 20, scratch=sc),
                           r2.ss2_resident_step(u, mf, d2, dt, 20, scratch=sc))


# ------------------------------------------------ kick_bc: the fused half kick

def _kick_inputs(cuda, shape, seed, offset=0):
    """A planar state (2, R, nx) and an (R, nx) m field on the card; with
    offset the state starts `offset` floats into its buffer (4 bytes past a
    16-byte boundary: the scalar form)."""
    rng = np.random.default_rng(seed)
    R, nx = int(np.prod(shape[:-1])), shape[-1]
    n = 2 * R * nx
    buf = torch.zeros(n + offset, device=cuda)
    buf[offset:] = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(cuda)
    up = buf[offset:].view(2, R, nx)
    m = torch.from_numpy((0.5 + rng.random((R, nx))).astype(np.float32)).to(
        cuda)
    return up, m


def _clamp_gather(out, shape, glob, offs):
    """out at the clamped index of each cell (the ghost copy's rule)."""
    idx = []
    for n, g, o in zip(shape, glob, offs):
        c = torch.arange(n, device=out.device)
        if o == 0:
            c[0] = 1
        if o + n == g:
            c[n - 1] = n - 2
        idx.append(c)
    grids = torch.meshgrid(*idx, indexing="ij")
    return out.reshape((2,) + shape)[(slice(None),) + grids].reshape(
        out.shape)


# (block, global grid or None, offsets, misaligned): 16-byte and scalar
# forms (nx % 4 in {0, 1, 2, 3}, a state 4 bytes off), 2D and 3D, whole
# grids, shard blocks at corners and inside, blocks of 2 cells per axis
_KICK_CASES = [((64, 64), None, None, 0), ((37, 129), None, None, 0),
               ((50, 130), None, None, 0), ((19, 303), None, None, 0),
               ((64, 64), None, None, 1), ((512, 1024), None, None, 0),
               ((32, 64), (64, 128), (32, 0), 0),
               ((31, 33), (62, 99), (31, 33), 0),
               ((16, 20, 32), None, None, 0), ((9, 11, 13), None, None, 0),
               ((8, 10, 16), (16, 20, 32), (8, 10, 16), 0),
               ((8, 10, 16), (16, 30, 32), (0, 10, 0), 0),
               ((2, 2, 2), (4, 4, 4), (2, 0, 2), 0),
               ((64, 64, 128), None, None, 0)]


@pytest.mark.parametrize("kind", ["cubic", "cubic_quintic", "saturable"])
@pytest.mark.parametrize("block,glob,offs,offset", _KICK_CASES,
                         ids=[f"{'x'.join(map(str, b))}"
                              f"{'-at-' + '.'.join(map(str, o)) if o else ''}"
                              f"{'-off' if f else ''}"
                              for b, _, o, f in _KICK_CASES])
def test_kick_bc_matches_plain_on_card(cuda, kind, block, glob, offs,
                                       offset):
    """kick_bc with and without the ghost copy against kick_bc_ref (rel-L2
    <= 1e-5); in the kernel's own output every ghost cell equals its source
    cell bit for bit; the input is left as it was; one launch each."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    up, m = _kick_inputs(cuda, block, 170 + len(block), offset)
    rho = nlse_density_planar(kind, m, sigma1=0.8, sigma2=-0.15, kappa=0.7)
    keep = up.clone()
    grid = tk.kick_grid(block, glob, offs)
    for g in (None, grid):
        before = tk.phase_kick_bc_planar.launches
        got, want = _kernel_and_plain(
            lambda: tk.phase_kick_bc_planar(up, rho, 0.3, g))
        assert tk.phase_kick_bc_planar.launches == before + 1
        assert _rel(got, want) <= FIELD_TOL
        assert torch.equal(up, keep)
    assert torch.equal(got, _clamp_gather(got, block, glob or block,
                                          offs or (0,) * len(block)))


def test_kick_bc_repeats_bit_for_bit(cuda):
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    for shape in ((1024, 1024), (37, 129)):
        up, m = _kick_inputs(cuda, shape, 180)
        rho = nlse_density_planar("saturable", m)
        grid = tk.kick_grid(shape)
        assert torch.equal(tk.phase_kick_bc_planar(up, rho, 0.3, grid),
                           tk.phase_kick_bc_planar(up, rho, 0.3, grid))


def test_kick_bc_rejects_bad_input(cuda):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    up, m = _kick_inputs(cuda, (16, 32), 181)
    rho = nlse_density_planar("cubic", m)
    with pytest.raises(ValueError):          # float64 state
        tk.phase_kick_bc_planar(up.double(), rho, 0.1)
    with pytest.raises(ValueError):          # not contiguous
        tk.phase_kick_bc_planar(up.transpose(1, 2), rho, 0.1)
    with pytest.raises(ValueError):          # a density without an m field
        tk.phase_kick_bc_planar(up, lambda u: u[0] * u[0], 0.1)
    with pytest.raises(ValueError):          # m of another shape
        tk.phase_kick_bc_planar(
            up, nlse_density_planar("cubic", m[:, :16].contiguous()), 0.1)
    with pytest.raises(ValueError):          # m on the CPU
        tk.phase_kick_bc_planar(
            up, nlse_density_planar("cubic", m.cpu()), 0.1)
    with pytest.raises(ValueError):          # a grid of other rows
        tk.phase_kick_bc_planar(up, rho, 0.1, tk.kick_grid((8, 32)))


# ------------------------------------------------ the real-wave path (P=1)

@pytest.mark.parametrize("shape,mode,j", [
    ((37, 50, 61), "reference", 0), ((37, 50, 61), "clean", 4),
    ((37, 50, 61), "aniso", 8), ((9, 11, 16), "reference", 8),
    ((9, 11, 13), "aniso", 4), ((5, 7, 33), "clean", 0)])
def test_3d_kernels_real_sign_minus_match_plain_on_card(cuda, shape, mode,
                                                        j):
    """pass1_3d and pass2 on real fields (P=1) with the real-wave problems'
    sign-flipped descriptor, and bc3d at P=1 exactly equal."""
    nz, ny, nx = shape
    desc = dict(_desc3d(shape, mode, cuda), sign=-1.0)
    w, *W = _fields_on(cuda, j + 2, (nz * ny, nx), 1, 70 + j)
    scal = torch.tensor([[0.7, 0.3]], device=cuda)
    q = torch.from_numpy(np.random.default_rng(71 + j).uniform(
        -0.5, 0.5, (j + 1, 2)).astype(np.float32)).to(cuda)
    for call in (lambda: t3.pass1_3d(scal, W[j], W[:j], desc),
                 lambda: t3.pass2(q, w, W)):
        _check(*_kernel_and_plain(call), [w, *W])
    got, want = _kernel_and_plain(
        lambda: tb.neumann_bc_planar_3d(w.clone(), shape))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _realwave(cuda, shape, aniso, integrator="gautschi"):
    from nlsolvers_tpu_torch.models import problems
    c = (1.0 + 0.4 * np.random.default_rng(72).random(shape)).astype(
        np.float32) if aniso else None
    prob = problems.realwave_problem("sine_gordon", shape, 5.0, 1e-3,
                                     c_field=c, integrator=integrator,
                                     dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(73)
    u0 = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return prob, prob.init(u0, np.zeros(shape, np.float32))


_COUNTERS = {"K1": tl.pass1_iso2d, "K1'": tl.pass1_aniso2d,
             "K2": tl.pipe_iso2d, "K2'": tl.pipe_aniso2d, "K3": tl.combine,
             "pass1_3d": t3.pass1_3d, "pass2": t3.pass2,
             "bc3d": tb.neumann_bc_planar_3d,
             "kick_bc": tk.phase_kick_bc_planar}


@pytest.mark.parametrize("shape,aniso,want", [
    ((64, 96), False, {"K1": 2, "K2": 18, "K3": 2}),
    ((64, 96), True, {"K1'": 2, "K2'": 18, "K3": 2}),
    ((12, 16, 40), False, {"pass1_3d": 18, "pass2": 20, "K3": 2,
                           "bc3d": 1}),
    ((12, 16, 40), True, {"pass1_3d": 18, "pass2": 20, "K3": 2,
                          "bc3d": 1})])
def test_realwave_gautschi_launches_on_card(cuda, shape, aniso, want):
    """A float32 Gautschi step at m=10 runs two matrix functions on the
    kernels (K3 at k=2, then k=1) and, in 3D, one bc3d; no kick_bc. In 3D
    each matrix function's start norm is one pass2 launch (its norm-only
    form). The kernels' step is within 1e-5 of the plain one."""
    prob, s = _realwave(cuda, shape, aniso)
    for f in _COUNTERS.values():
        f.launches = 0
    got = prob.step(s, 1)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in _COUNTERS.items() if f.launches}
    assert counts == want
    config.kernel_mode = "off"
    try:
        plain = prob.step(s, 1)
    finally:
        config.kernel_mode = "auto"
    assert _rel(got[0], plain[0]) <= FIELD_TOL
    assert got[1] is s[0]


def test_realwave_sv_launches_on_card(cuda):
    """SV applies the plain Laplacian: no Lanczos kernel; 3D float32 still
    runs bc3d once per step."""
    for shape, want in (((64, 96), {}), ((12, 16, 40), {"bc3d": 1})):
        prob, s = _realwave(cuda, shape, False, "sv")
        for f in _COUNTERS.values():
            f.launches = 0
        prob.step(s, 1)
        assert {k: f.launches for k, f in _COUNTERS.items()
                if f.launches} == want


def _datagen_batch(B, n=256):
    """B lanes as datagen draws them at 256^2: layered c(x), piecewise
    m(x) (the port's fields module), Gaussian packed ICs, float32."""
    from nlsolvers_tpu_torch.pipeline import fields, grids
    g = grids.Grid2D(n, n, 10.0)
    rng = np.random.default_rng(74)
    c = [fields.sample_c_field(g, rng, kind="layered")[0] for _ in range(B)]
    m = [fields.sample_m_field(g, rng, kind="piecewise", c=c_)[0]
         for c_ in c]
    x = np.linspace(-10.0, 10.0, n)
    u0 = np.stack([np.exp(-((x[:, None] - b) ** 2 + x[None, :] ** 2) / 4.0)
                   * np.exp(0.5j * x[None, :]) for b in range(B)])
    packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
    return (packed, np.stack(m).astype(np.float32),
            np.stack(c).astype(np.float32))


def test_datagen_engine_launches_on_card(cuda):
    """One batched step of the 2D NLSE datagen engine at m=20 is ONE step
    over every lane: exactly 1 K1' + 19 K2' + 1 K3 + 2 kick_bc launches
    whatever B, no iso launch, no bc3d."""
    from nlsolvers_tpu_torch.pipeline import engine
    B = 3
    packed, m, c = _datagen_batch(B)
    fn = engine.make_nlse_trajectory_fn("cubic", (256, 256), 10.0, 6e-4,
                                        krylov_m=20, device=cuda)
    assert fn.planar and fn.batched
    torch.cuda.synchronize()
    for f in _COUNTERS.values():
        f.launches = 0
    fn(packed, m, c, 2, 1)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in _COUNTERS.items() if f.launches} == {
        "K1'": 1, "K2'": 19, "K3": 1, "kick_bc": 2}


def test_datagen_engine_bit_equal_to_problem_on_card(cuda):
    """Each lane of the batched engine equals nlse_problem with its own m
    and c run alone on the card, bit for bit: each batched kernel gives its
    lanes the unbatched launch's bits, the scalar ops are elementwise, and
    the batched eigh gives each matrix the single-matrix eigh's bits."""
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.pipeline import engine
    B = 3
    packed, m, c = _datagen_batch(B)
    out = engine.make_nlse_trajectory_fn("cubic", (256, 256), 10.0, 6e-4,
                                         krylov_m=20, device=cuda)(
        packed, m, c, 3, 4)
    for b in range(B):
        prob = problems.nlse_problem("cubic", (256, 256), 10.0, 6e-4,
                                     m_field=m[b], c_field=c[b],
                                     krylov_m=20, device=cuda)
        ref = problems.run(prob, prob.init(packed[b]), 3, 4)
        assert torch.equal(out[b, :, 0], ref.real)
        assert torch.equal(out[b, :, 1], ref.imag)


# ------------------------------------------------ batched kernels (B lanes)

def _batch_field(cuda, gen, B, P, shape, vec):
    """A (B, P, ny, nx) field; vec False puts it 4 bytes off a 16-byte
    boundary, which sends every kernel to its scalar form."""
    n = B * P * shape[0] * shape[1]
    off = 0 if vec else 1
    return torch.randn(n + off, generator=gen, device=cuda)[off:].view(
        (B, P) + shape)


def _batch_desc(op, cuda, gen, B, shape, vec):
    ny, nx = shape
    if op == "iso":
        return _desc(ny, nx, "reference"), None
    c = 1.0 + 0.4 * torch.rand((B, ny, nx), generator=gen, device=cuda)
    d = tops.batched_aniso_laplacian_2d(list(c), 0.02, 0.02, device=cuda)
    if not vec:                       # weights off a 16-byte boundary too
        for k in ("wx", "wy"):
            w = torch.empty(B * ny * nx + 1, device=cuda)[1:].view(B, ny, nx)
            w.copy_(d[k])
            d[k] = w
    return d, [dict(d, wx=d["wx"][b], wy=d["wy"][b]) for b in range(B)]


def _lane_equal(got, lanes):
    """Each output of a batched launch against the B unbatched launches'."""
    for b, want in enumerate(lanes):
        for x, y in zip(got, want):
            assert torch.equal(x[b], y), (b, x.shape)


@pytest.mark.parametrize("op", ["iso", "aniso"])
@pytest.mark.parametrize("P,vec", [(2, True), (2, False), (1, True),
                                   (1, False)])
def test_batched_kernels_bit_equal_to_lane_launches_on_card(cuda, op, P,
                                                            vec):
    """K1/K1' (j = 0 with the norm, j = 19), K2/K2' (j up to 19, and the
    last iteration at j = 18) and K3 (m = 20, k = 1 and 2) at B = 8, 256^2,
    in their 16-byte and scalar forms: ONE launch each, whose lane b equals
    the unbatched launch on lane b bit for bit."""
    B, shape = 8, (256, 256)
    gen = torch.Generator(device=cuda).manual_seed(900 + P + 10 * vec)
    desc, lane_desc = _batch_desc(op, cuda, gen, B, shape, vec)
    lane_desc = lane_desc or [desc] * B
    cols = [_batch_field(cuda, gen, B, P, shape, vec) for _ in range(22)]
    p1 = tl.pass1_iso2d if op == "iso" else tl.pass1_aniso2d
    pp = tl.pipe_iso2d if op == "iso" else tl.pipe_aniso2d
    for j in (0, 19):
        scal = torch.rand((B, 1, 2), generator=gen, device=cuda)
        before = p1.launches
        got = p1(scal, cols[j], cols[:j], desc, norm=True)
        assert p1.launches == before + 1
        _lane_equal(got, [p1(scal[b], cols[j][b], [w[b] for w in cols[:j]],
                             lane_desc[b], norm=True) for b in range(B)])
    for j, last in ((0, False), (7, False), (15, False), (19, False),
                    (18, True)):
        scal = torch.rand((B, j + 2, 2), generator=gen, device=cuda) - 0.5
        before = pp.launches
        got = pp(scal, cols[21], cols[:j + 1], desc, last)
        assert pp.launches == before + 1
        _lane_equal(got, [pp(scal[b], cols[21][b],
                             [w[b] for w in cols[:j + 1]], lane_desc[b],
                             last) for b in range(B)])
    for k in (1, 2):
        q = torch.rand((B, k, 20, 2), generator=gen, device=cuda) - 0.5
        before = tl.combine.launches
        got = tl.combine(q, cols[:20])
        assert tl.combine.launches == before + 1
        _lane_equal(got, [tl.combine(q[b], [w[b] for w in cols[:20]])
                          for b in range(B)])


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("kind", ["cubic", "saturable"])
def test_batched_kick_bc_bit_equal_to_lane_launches_on_card(cuda, vec,
                                                            kind):
    """kick_bc on a (8, 2, 256, 256) batch with per-lane m fields, with and
    without the ghost copy, 16-byte and scalar forms: one launch, each lane
    the unbatched launch's bits."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    B, shape = 8, (256, 256)
    gen = torch.Generator(device=cuda).manual_seed(950 + vec)
    up = _batch_field(cuda, gen, B, 2, shape, vec)
    m = 0.5 + _batch_field(cuda, gen, B, 1, shape, vec)[:, 0].abs()
    m = m if vec else torch.empty(m.numel() + 1, device=cuda)[1:].view(
        m.shape).copy_(m)
    rho = nlse_density_planar(kind, m, kappa=0.7)
    for grid in (None, tk.kick_grid(shape)):
        before = tk.phase_kick_bc_planar.launches
        got = tk.phase_kick_bc_planar(up, rho, 0.3, grid)
        assert tk.phase_kick_bc_planar.launches == before + 1
        for b in range(B):
            lane = nlse_density_planar(kind, m[b], kappa=0.7)
            assert torch.equal(got[b], tk.phase_kick_bc_planar(
                up[b], lane, 0.3, grid))


def test_batched_wrappers_reject_bad_input(cuda):
    """A batch the kernels cannot take raises; nothing falls back."""
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density_planar
    desc = _desc(16, 16, "reference")
    u = torch.zeros((3, 2, 16, 16), device=cuda)
    with pytest.raises(ValueError):          # scalars without the lanes
        tl.pass1_iso2d(torch.eye(1, 2, device=cuda), u, [], desc)
    with pytest.raises(ValueError):          # columns of other lanes
        tl.pipe_iso2d(torch.zeros((3, 2, 2), device=cuda), u, [u[:2]], desc,
                      False)
    c = torch.ones((2, 16, 16), device=cuda)
    d2 = tops.batched_aniso_laplacian_2d(list(c), 0.1, 0.1, device=cuda)
    with pytest.raises(ValueError):          # weights of 2 lanes, 3 fields
        tl.pass1_aniso2d(torch.zeros((3, 1, 2), device=cuda), u, [], d2)
    with pytest.raises(ValueError):          # one m field for 3 lanes
        tk.phase_kick_bc_planar(u, nlse_density_planar("cubic", c[0]), 0.1)


# ------------------------------------------------ batched 3D kernels

def _batch3d_desc(mode, cuda, gen, B, shape):
    """(batched descriptor, the lanes' descriptors) of a 3D operator."""
    if mode != "aniso":
        d = _desc3d(shape, mode, cuda)
        return d, [d] * B
    c = 1.0 + 0.4 * torch.rand((B,) + shape, generator=gen, device=cuda)
    dx = 2.0 * 5.0 / (shape[-1] - 1)
    d = tops.batched_aniso_laplacian_3d(list(c), dx, device=cuda)
    return d, [dict(d, **{k: d[k][b] for k in ("wx", "wy", "wz")})
               for b in range(B)]


def _batch_check(got, want, fields):
    """A batched launch against the plain batched version, lane by lane:
    fields by rel-L2 <= 1e-5, dots within 1e-4 of the largest squared norm
    of the lane's fields."""
    for b in range(fields[0].shape[0]):
        scale = max(float(f[b].norm()) ** 2 for f in fields)
        for x, y in zip(got, want):
            if x.dim() == 4:
                assert _rel(x[b], y[b]) <= FIELD_TOL
            else:
                assert float((x[b] - y[b]).abs().max()) <= DOT_TOL * scale


@pytest.mark.parametrize("shape", [(37, 50, 61), (9, 11, 16), (5, 7, 33),
                                   (16, 16, 128)])
@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("P", [1, 2])
def test_batched_3d_kernels_bit_equal_to_lane_launches_on_card(cuda, shape,
                                                               mode, P):
    """pass1_3d (j = 0, 4, 9), pass2 (0, 1 and 10 columns; 0 is the
    norm-only form) and bc3d on B = 4 lanes of a ragged or 128-column grid:
    ONE launch each, lane b bit-equal to the unbatched launch on lane b and
    within the gates of the plain batched version (bc3d exactly)."""
    B = 4
    nz, ny, nx = shape
    gen = torch.Generator(device=cuda).manual_seed(1000 + P)
    desc, lanes = _batch3d_desc(mode, cuda, gen, B, shape)
    desc = dict(desc, sign=-1.0) if P == 1 else desc
    lanes = [dict(d, sign=desc["sign"]) for d in lanes]
    cols = [torch.randn((B, P, nz * ny, nx), generator=gen, device=cuda)
            for _ in range(11)]
    for j in (0, 4, 9):
        scal = torch.rand((B, 1, 2), generator=gen, device=cuda)
        before = t3.pass1_3d.launches
        got, want = _kernel_and_plain(
            lambda: t3.pass1_3d(scal, cols[j], cols[:j], desc))
        assert t3.pass1_3d.launches == before + 1
        _batch_check(got, want, cols[:j + 1] + [want[0]])
        _lane_equal(got, [t3.pass1_3d(scal[b], cols[j][b],
                                      [w[b] for w in cols[:j]], lanes[b])
                          for b in range(B)])
    for nw in (0, 1, 10):
        q = (torch.rand((B, nw, 2), generator=gen, device=cuda) - 0.5
             if nw else None)
        before = t3.pass2.launches
        got, want = _kernel_and_plain(lambda: t3.pass2(q, cols[10],
                                                       cols[:nw]))
        assert t3.pass2.launches == before + 1
        _batch_check(got, want, cols[:nw + 1] + [want[0]])
        _lane_equal(got, [t3.pass2(None if q is None else q[b], cols[10][b],
                                   [w[b] for w in cols[:nw]])
                          for b in range(B)])
    up = cols[10].clone()
    alone = [tb.neumann_bc_planar_3d(up[b].clone(), shape) for b in range(B)]
    before = tb.neumann_bc_planar_3d.launches
    got, want = _kernel_and_plain(
        lambda: tb.neumann_bc_planar_3d(up.clone(), shape))
    torch.cuda.synchronize()
    assert tb.neumann_bc_planar_3d.launches == before + 1
    assert torch.equal(got, want)
    _lane_equal([got], [[a] for a in alone])


def test_batched_combine_real_k2_bit_equal_on_card(cuda):
    """K3 at k = 2 on a real (P = 1) batch of merged 3D views, the real-wave
    step's first combine: one launch, each lane the unbatched launch's
    bits, within 1e-5 of the plain version."""
    B, R, nx = 8, 16 * 16, 128
    gen = torch.Generator(device=cuda).manual_seed(1100)
    W = [torch.randn((B, 1, R, nx), generator=gen, device=cuda)
         for _ in range(10)]
    q = torch.rand((B, 2, 10, 2), generator=gen, device=cuda) - 0.5
    q[..., 1] = 0.0
    got, want = _kernel_and_plain(lambda: tl.combine(q, W))
    for x, y in zip(got, want):
        for b in range(B):
            assert _rel(x[b], y[b]) <= FIELD_TOL
    _lane_equal(got, [tl.combine(q[b], [w[b] for w in W]) for b in range(B)])


@pytest.mark.parametrize("mode", ["reference", "aniso"])
def test_batched_twopass_bit_equal_to_lanes_on_card(cuda, mode):
    """The two-pass 3D loop on a batch of B = 3 complex lanes at m = 10:
    every column, s, alpha, beta and beta0 of lane b equal the unbatched
    loop's on lane b, bit for bit."""
    B, shape = 3, (12, 16, 40)
    gen = torch.Generator(device=cuda).manual_seed(1200)
    desc, lanes = _batch3d_desc(mode, cuda, gen, B, shape)
    u = torch.randn((B, 2, 12 * 16, 40), generator=gen, device=cuda)
    got = t3.lanczos_twopass(u, desc, 10)
    for b in range(B):
        want = t3.lanczos_twopass(u[b], lanes[b], 10)
        for xs, ys in zip(got[:4], want[:4]):
            for x, y in zip(xs, ys):
                assert torch.equal(x[b], y)
        assert torch.equal(got[4][b], want[4])


def _engine_batch(cuda, path, B):
    """(trajectory function, its arguments, the lanes' problems run alone)
    of one of the batched engine paths at a small size."""
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.pipeline import engine
    shape = (64, 96) if path == "rw2d" else (12, 16, 40)
    rng = np.random.default_rng(1300)
    m = (0.5 + rng.random((B,) + shape)).astype(np.float32)
    c = (1.0 + 0.4 * rng.random((B,) + shape)).astype(np.float32)
    if path == "nlse3d":
        u0 = (0.3 * rng.standard_normal((B, 2) + shape)).astype(np.float32)
        fn = engine.make_nlse_trajectory_fn("cubic", shape, 5.0, 1e-3,
                                            device=cuda)

        def alone(b, S, f):
            prob = problems.nlse_problem("cubic", shape, 5.0, 1e-3,
                                         m_field=m[b], c_field=c[b],
                                         device=cuda)
            ref = problems.run(prob, prob.init(u0[b]), S, f)
            return torch.stack([ref.real, ref.imag], dim=1)

        return fn, (u0, m, c), alone
    u0 = (0.3 * rng.standard_normal((B,) + shape)).astype(np.float32)
    v0 = np.zeros_like(u0)
    fn = engine.make_realwave_trajectory_fn("sine_gordon", shape, 5.0, 1e-3,
                                            device=cuda)

    def alone(b, S, f):
        prob = problems.realwave_problem("sine_gordon", shape, 5.0, 1e-3,
                                         m_field=m[b], c_field=c[b],
                                         dtype=torch.float32, device=cuda)
        return problems.run(prob, prob.init(u0[b], v0[b]), S, f)

    return fn, (u0, v0, m, c), alone


@pytest.mark.parametrize("path,want", [
    ("rw2d", {"K1'": 2, "K2'": 18, "K3": 2}),
    ("nlse3d", {"pass1_3d": 9, "pass2": 10, "K3": 1, "kick_bc": 2}),
    ("rw3d", {"pass1_3d": 18, "pass2": 20, "K3": 2, "bc3d": 1})])
def test_batched_engine_paths_launches_and_lanes_on_card(cuda, path, want):
    """One batched step of each new batched engine path (m = 10, c(x)) makes
    the same counted launches for B = 1 and B = 3, and each lane over 8
    steps equals its problem run alone on the card, bit for bit."""
    for B in (1, 3):
        fn, args, alone = _engine_batch(cuda, path, B)
        assert fn.batched
        torch.cuda.synchronize()
        for f in _COUNTERS.values():
            f.launches = 0
        fn(*args, 2, 1)
        torch.cuda.synchronize()
        assert {k: f.launches for k, f in _COUNTERS.items()
                if f.launches} == want
    out = fn(*args, 3, 4)
    for b in range(3):
        ref = alone(b, 3, 4)
        if path == "nlse3d":
            assert torch.equal(out[b], ref)
        else:
            assert torch.equal(out[0][b], ref[0])
            assert torch.equal(out[1][b], ref[1])


# ------------------------------------------------ batched K5 and K8

def _batch_iter_desc(mode, cuda, gen, B):
    """(batched descriptor, lanes' descriptors, rows, nx) of each operator
    K5 takes, on ragged grids."""
    if mode in ("reference", "clean"):
        d = _desc(37, 131, mode)
        return d, [d] * B, 37, 131
    if mode == "aniso2d":
        c = 1.0 + 0.4 * torch.rand((B, 19, 300), generator=gen, device=cuda)
        d = tops.batched_aniso_laplacian_2d(list(c), 0.02, 0.02, device=cuda)
        return d, [dict(d, wx=d["wx"][b], wy=d["wy"][b])
                   for b in range(B)], 19, 300
    shape = (9, 11, 16) if mode.endswith("16") else (9, 11, 13)
    d = _desc3d(shape, mode[:-2].replace("3d", ""), cuda)
    return d, [d] * B, 99, shape[-1]


_BATCH_ITER_CASES = [("reference", 2, "plan"), ("clean", 1, "plan"),
                     ("aniso2d", 2, "plan"), ("aniso2d", 1, "global"),
                     ("reference3d", 2, "plan"), ("clean3d", 1, "global"),
                     ("reference3d16", 2, "onchip7"),
                     ("reference", 2, "global"), ("aniso2d", 2, "onchip7")]


@pytest.mark.parametrize("mode,P,form", _BATCH_ITER_CASES,
                         ids=[f"{m}-P{P}-{f}"
                              for m, P, f in _BATCH_ITER_CASES])
def test_batched_iter_step_bit_equal_to_lane_launches_on_card(
        cuda, monkeypatch, mode, P, form):
    """K5 on B = 3 lanes (j = 0, 4, 9), w on chip or in the scratch: ONE
    launch, within the gates of the plain batched version, lane b
    bit-equal to the unbatched launch on lane b (which takes the same grid),
    and the batch the same bits in the other form of w on that grid."""
    B = 3
    gen = torch.Generator(device=cuda).manual_seed(1400 + P)
    desc, lanes, rows, nx = _batch_iter_desc(mode, cuda, gen, B)
    segs = -(-nx // tl.STRIP_COLS) * rows
    if form != "plan":
        grid = 7 if form == "onchip7" else min(
            segs, tl._lib().lz_coop_max_blocks())
        monkeypatch.setattr(tl, "iter_form",
                            lambda *a: (form == "onchip7", grid))
    cols = [torch.randn((B, P, rows, nx), generator=gen, device=cuda)
            for _ in range(10)]
    for j in (0, 4, 9):
        s = 0.2 + 0.8 * torch.rand((B, j + 1), generator=gen, device=cuda)
        scal = torch.cat([s[:, j:j + 1], torch.full((B, 1), 0.3,
                                                    device=cuda), s],
                         dim=1)[:, None].contiguous()
        before = tl.iter_step.launches
        got, want = _kernel_and_plain(
            lambda: tl.iter_step(scal, cols[j], cols[:j], desc))
        assert tl.iter_step.launches == before + 1
        w0 = tl._pass1_ref(scal[..., :2], cols[j], cols[:j],
                           tl._operator_ref(cols[j], desc))[0]
        _batch_check(got, want, cols[:j + 1] + [w0, want[0]])
        _lane_equal(got, [tl.iter_step(scal[b], cols[j][b],
                                       [w[b] for w in cols[:j]], lanes[b])
                          for b in range(B)])
        onchip, grid = tl.iter_form(P, rows, nx, tl._iter_opk(desc, "t"),
                                    j, nx % 4 == 0, B)
        monkeypatch.setattr(tl, "iter_form", lambda *a: (not onchip, grid))
        other = tl.iter_step(scal, cols[j], cols[:j], desc)
        monkeypatch.setattr(tl, "iter_form", lambda *a: (onchip, grid))
        assert all(torch.equal(x, y) for x, y in zip(got, other))


@pytest.mark.parametrize("shape", [(37, 50, 61), (9, 31, 260),
                                   (16, 16, 128)])
@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("P", [1, 2])
def test_batched_pipe_3d_bit_equal_to_lane_launches_on_card(cuda, shape,
                                                            mode, P):
    """K8 on B = 3 lanes (j = 0, 5), the sign flipped at P = 1: ONE launch,
    within the gates of the plain batched version, lane b bit-equal to the
    unbatched launch on lane b; two launches bit for bit."""
    B = 3
    nz, ny, nx = shape
    gen = torch.Generator(device=cuda).manual_seed(1500 + P)
    desc, lanes = _batch3d_desc(mode, cuda, gen, B, shape)
    desc = dict(desc, sign=-1.0) if P == 1 else desc
    lanes = [dict(d, sign=desc["sign"]) for d in lanes]
    av, *cols = [torch.randn((B, P, nz * ny, nx), generator=gen,
                             device=cuda) for _ in range(7)]
    for j in (0, 5):
        scal = torch.rand((B, j + 2, 2), generator=gen, device=cuda) - 0.5
        before = t3.pipe_3d.launches
        got, want = _kernel_and_plain(
            lambda: t3.pipe_3d(scal, av, cols[:j + 1], desc))
        assert t3.pipe_3d.launches == before + 1
        _batch_check(got, want, cols[:j + 1] + [av, want[0], want[1]])
        _lane_equal(got, [t3.pipe_3d(scal[b], av[b],
                                     [w[b] for w in cols[:j + 1]], lanes[b])
                          for b in range(B)])
        again = t3.pipe_3d(scal, av, cols[:j + 1], desc)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("switch,mode,shape", [
    ("fused_iter", "reference", (40, 72)), ("fused_iter", "aniso2d", None),
    ("fused_iter", "reference3d", None), ("pipeline_3d", "reference", None),
    ("pipeline_3d", "aniso", None)])
def test_batched_switched_loops_bit_equal_to_lanes_on_card(
        cuda, monkeypatch, switch, mode, shape):
    """lanczos_planar under each switch on B = 3 lanes at m = 10: every
    column, s, alpha, beta and beta0 of lane b equal the unbatched run's,
    bit for bit."""
    B = 3
    gen = torch.Generator(device=cuda).manual_seed(1600)
    monkeypatch.setattr(config, switch, True)
    if switch == "fused_iter":
        if shape is not None:
            desc = _desc(*shape, mode)
            lanes, rows, nx = [desc] * B, *shape
        else:
            desc, lanes, rows, nx = _batch_iter_desc(mode, cuda, gen, B)
    else:
        desc, lanes = _batch3d_desc(mode, cuda, gen, B, (12, 16, 40))
        rows, nx = 12 * 16, 40
    u = torch.randn((B, 2, rows, nx), generator=gen, device=cuda)
    got = tl.lanczos_planar(u, desc, 10)
    for b in range(B):
        want = tl.lanczos_planar(u[b], lanes[b], 10)
        for xs, ys in zip(got[:4], want[:4]):
            for x, y in zip(xs, ys):
                assert torch.equal(x[b], y)
        assert torch.equal(got[4][b], want[4])


@pytest.mark.parametrize("integrator,shape,want", [
    ("sewi", (64, 96), {"K1'": 3, "K2'": 27, "K3": 3}),
    ("sewi_fused", (64, 96), {"K1'": 2, "K2'": 18, "K3": 2}),
    ("gautschi", (12, 16, 40), {"pass1_3d": 27, "pass2": 30, "K3": 3,
                                "bc3d": 1}),
    ("sewi_fused", (12, 16, 40), {"pass1_3d": 18, "pass2": 20, "K3": 2,
                                  "bc3d": 1})])
def test_batched_twostep_engine_launches_and_lanes_on_card(
        cuda, integrator, shape, want):
    """The batched two-step engine (m = 10, c(x)): the second step's
    counted launches are the same for B = 1 and B = 3, and each lane over 8
    steps equals nlse_problem run alone on the card, bit for bit."""
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.pipeline import engine
    rng = np.random.default_rng(1700)
    for B in (1, 3):
        m = (0.5 + rng.random((B,) + shape)).astype(np.float32)
        c = (1.0 + 0.4 * rng.random((B,) + shape)).astype(np.float32)
        u0 = (0.3 * rng.standard_normal((B, 2) + shape)).astype(np.float32)
        fn = engine.make_nlse_trajectory_fn("cubic", shape, 5.0, 1e-3,
                                            krylov_m=10,
                                            integrator=integrator,
                                            device=cuda)
        assert fn.batched
        counts = []
        for n in (1, 2):
            torch.cuda.synchronize()
            for f in _COUNTERS.values():
                f.launches = 0
            fn(u0, m, c, 2, n)
            torch.cuda.synchronize()
            counts.append({k: f.launches for k, f in _COUNTERS.items()})
        assert {k: counts[1][k] - counts[0][k] for k in _COUNTERS
                if counts[1][k] != counts[0][k]} == want
    out = fn(u0, m, c, 3, 4)
    for b in range(3):
        prob = problems.nlse_problem("cubic", shape, 5.0, 1e-3,
                                     m_field=m[b], c_field=c[b],
                                     krylov_m=10, integrator=integrator,
                                     device=cuda)
        ref = problems.run(prob, prob.init(u0[b]), 3, 4)
        assert torch.equal(out[b], torch.stack([ref.real, ref.imag], dim=1))
