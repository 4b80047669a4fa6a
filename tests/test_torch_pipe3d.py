"""The 3D single-pass pipe of the port (config.pipeline_3d: K8 `pipe_3d`,
ops/cuda/lanczos3d.py) against the JAX package's (pallas_pipeline_3d:
`_pipe3d_call` driven by lanczos3d_pipe.lanczos_pipe3d, in Pallas interpret
mode, as tests/test_pallas.py runs it).

Inputs are made with numpy from a seed and given to both sides, on the
merged (P, nz*ny, nx) row view. Tolerances (float32, the same arithmetic):
* fields: rel-L2 <= 1e-5; reduced dots <a, b>: |got - want| <= 1e-4 *
  ||a|| ||b|| (the summation order differs);
* Lanczos columns W_i: rel-L2 <= 1e-4 (float32 rounding doubles per
  iteration, tests/test_torch_lanczos2d.py's gate); s, alpha, beta and the
  matrix function: rel-L2 <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu.ops.pallas import lanczos3d_pipe as j3
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3

torch.set_num_threads(1)

FIELD_TOL = 1e-5
DOT_TOL = 1e-4
COL_TOL = 1e-4
SHAPE = (16, 16, 128)
M = 8


@pytest.fixture
def pipe3d_on(monkeypatch):
    """The 3D pipe switched on in both packages (JAX's y-slab path)."""
    monkeypatch.setattr(jconfig, "pallas_ytile_3d", True)
    monkeypatch.setattr(jconfig, "pallas_pipeline_3d", True)
    monkeypatch.setattr(config, "pipeline_3d", True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _descs(mode, sign=1.0):
    """(JAX descriptor, port descriptor) of a 3D operator on SHAPE."""
    dx = 2.0 * 5.0 / (SHAPE[-1] - 1)
    if mode == "aniso":
        c = (1.0 + 0.4 * np.random.default_rng(3).random(SHAPE)).astype(
            np.float32)
        jd = jops.anisotropic_laplacian_3d(c, dx)._pallas_desc
        td = tops.anisotropic_laplacian_3d(c, dx, device="cpu").kernel_desc
    else:
        jd = jops.laplacian_3d(SHAPE, dx, variant=mode,
                               dtype=jnp.float32)._pallas_desc
        td = tops.laplacian_3d(SHAPE, dx, variant=mode,
                               device="cpu").kernel_desc
    return dict(jd, sign=sign), dict(td, sign=sign)


def _fields(k, P, seed):
    nz, ny, nx = SHAPE
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((P, nz * ny, nx)).astype(np.float32)
            for _ in range(k)]


def _check_dots(got, want, lefts, right):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i, a in enumerate(lefts):
        scale = np.linalg.norm(a) * np.linalg.norm(right)
        assert np.abs(got[i] - want[i]).max() <= DOT_TOL * scale, i


def _pallas_pipe3d(j, mode, jdesc, scal, av, W, P):
    """JAX's _pipe3d_call in interpret mode, its inputs built as
    lanczos_pipe3d builds them."""
    nz, ny, nx = SHAPE
    kmode = "aniso3d" if mode == "aniso" else "iso3d"
    ty = j3.pick_ty3d(nz, ny, nx, j, P, 4 if mode == "aniso" else 0)
    as4 = lambda a: jnp.asarray(a).reshape(P, nz, ny, nx)
    halos = jnp.stack([j3.gather_y_halos(as4(a), ty,
                                         "seam" if mode == "aniso" else mode)
                       for a in [av] + W])
    args = [jnp.asarray(scal), as4(av),
            halos.reshape((j + 2) * P, nz, ny // ty, 2, nx)]
    if mode == "aniso":
        wx4, wy4, wz4 = (jnp.asarray(jdesc[k]).reshape(1, nz, ny, nx)
                         for k in ("wx", "wy", "wz"))
        args += [wx4, wy4, j3._gather_wy_halos(wy4, ty), wz4]
    args += [as4(a) for a in W]
    res = j3._pipe3d_call(j, P, nz, ny, nx, ty, jdesc["scale"],
                          jdesc["sign"], jdesc["variant"], True, kmode)(*args)
    R = nz * ny
    return [np.asarray(r).reshape(P, R, nx) if r.ndim == 4 else np.asarray(r)
            for r in res]


@pytest.mark.parametrize("mode,j,P", [("reference", 0, 2), ("clean", 3, 2),
                                      ("aniso", 3, 2), ("reference", 2, 1)])
def test_pipe_3d_ref_matches_pallas(mode, j, P):
    """Every output of one pipelined iteration, in _pipe3d_call's order."""
    jdesc, tdesc = _descs(mode)
    av, *W = _fields(j + 2, P, 10 + j)
    scal = np.random.default_rng(5).uniform(-0.5, 0.5, (j + 2, 2)).astype(
        np.float32)
    scal[0] = (0.8, 0.0)
    wn_j, avn_j, nsq_j, gram_j, d_j = _pallas_pipe3d(j, mode, jdesc, scal, av,
                                                     W, P)
    wn, avn, nsq, gram, d = t3.pipe_3d_ref(
        torch.from_numpy(scal), torch.from_numpy(av),
        [torch.from_numpy(w) for w in W], tdesc)
    assert _rel(wn.numpy(), wn_j) <= FIELD_TOL
    assert _rel(avn.numpy(), avn_j) <= FIELD_TOL
    assert abs(float(nsq[0, 0]) - float(nsq_j[0, 0])) <= (
        DOT_TOL * float(nsq_j[0, 0]))
    _check_dots(gram.numpy(), gram_j, W, wn_j)
    _check_dots(d.numpy(), d_j, W + [wn_j], avn_j)


@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
def test_pipe3d_loop_matches_pallas(mode, pipe3d_on):
    """Every column, s_j and T entry of an m=8 run through the pipe (and,
    for one operator, the matrix function) against JAX's lanczos_pipe3d;
    the CPU launches nothing."""
    jdesc, tdesc = _descs(mode)
    (u,) = _fields(1, 2, 40)
    t = 1j * 1e-3
    with_y = mode == "reference"     # one mode: interpret mode is slow

    @jax.jit
    def pallas(uj):
        return (jl.lanczos_planar(uj, jdesc, M, interpret=True),
                jl.matfunc_apply_planar(uj, jdesc, np.complex64(t), "exp", M,
                                        interpret=True) if with_y else None)

    (W_j, s_j, a_j, b_j, b0_j), y_j = pallas(jnp.asarray(u))
    counters = (t3.pipe_3d, t3.pass1_3d, t3.pass2, tl.pipe_iso2d)
    before = [f.launches for f in counters]
    W_t, s_t, a_t, b_t, b0_t = tl.lanczos_planar(torch.from_numpy(u), tdesc,
                                                 M)
    for x, y in zip(W_t, W_j):
        assert _rel(x.numpy(), y) <= COL_TOL
    assert _rel(torch.stack(s_t).numpy(), jnp.stack(s_j)) <= FIELD_TOL
    assert _rel(torch.stack(a_t).numpy(), jnp.stack(a_j)) <= FIELD_TOL
    assert _rel(torch.stack(b_t).numpy(), jnp.stack(b_j)) <= FIELD_TOL
    assert abs(float(b0_t) - float(b0_j)) <= FIELD_TOL * float(b0_j)
    if with_y:
        y_t = tl.matfunc_apply_planar(torch.from_numpy(u), tdesc, t, "exp", M)
        assert _rel(y_t.numpy(), y_j) <= FIELD_TOL
    assert [f.launches for f in counters] == before


def test_pipe3d_realwave_matches_pallas(pipe3d_on, monkeypatch):
    """P = 1 through the sign-flipped real-wave descriptor with
    sinc2_sqrt_half, as tests/test_pallas.py's 3D real-wave case; the port's
    pipe kernels are the ones called."""
    jdesc, tdesc = _descs("reference", sign=-1.0)
    (u,) = _fields(1, 1, 41)
    m = 10
    want = jax.jit(lambda uj: jl.matfunc_apply_planar(
        uj, jdesc, np.float32(1e-2), "sinc2_sqrt_half", m,
        interpret=True))(jnp.asarray(u))
    seen = []
    real = t3.pipe_3d
    monkeypatch.setattr(t3, "pipe_3d", lambda *a: seen.append(1) or real(*a))
    got = tl.matfunc_apply_planar(torch.from_numpy(u), tdesc, 1e-2,
                                  "sinc2_sqrt_half", m)
    assert got.shape == u.shape and len(seen) == m - 2
    assert _rel(got.numpy(), want) <= FIELD_TOL


@pytest.mark.parametrize("shape,fit", [((128, 128, 128), 264),
                                       ((256, 256, 256), 264),
                                       ((37, 50, 61), 264), ((3, 3, 3), 132),
                                       ((512, 20, 300), 132),
                                       ((512, 512, 512), 264)])
def test_pipe3d_brick_takes_the_fewest_steps(shape, fit):
    """K8's brick: a grid no larger than the blocks that fit nor the
    bricks, and the pz whose busiest block walks the fewest plane steps
    (brute force over every pz), the longest brick among equals."""
    nz, ny, nx = shape
    pz, grid = t3.pipe3d_brick(nz, ny, nx, fit)
    per_plane = -(-nx // t3.PIPE3D_COLS) * -(-ny // t3.PIPE3D_ROWS)

    def steps(p):
        return -(-per_plane * -(-nz // p) // fit) * (p + 2)

    assert 1 <= pz <= nz
    assert grid == min(per_plane * -(-nz // pz), fit)
    best = min(steps(p) for p in range(1, nz + 1))
    assert steps(pz) == best
    assert pz == max(p for p in range(1, nz + 1) if steps(p) == best)


def test_pipe3d_brick_at_the_measured_points():
    """128^3 and 256^3 on 264 resident blocks (two per SM of an H100):
    22 x 12 bricks of 11 planes, and 86 x 3 bricks of 86 planes."""
    assert t3.pipe3d_brick(128, 128, 128, 264) == (11, 264)
    assert t3.pipe3d_brick(256, 256, 256, 264) == (86, 258)
