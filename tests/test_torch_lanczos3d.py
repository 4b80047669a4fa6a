"""3D fused Lanczos and ghost copy of the port: plain versions vs the JAX
Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_pallas.py runs them; the port's plain versions (`*_ref`, what a
wrapper runs for a CPU tensor) get the same seeded float32 inputs on the
merged (P, nz*ny, nx) row view.

Tolerances (float32):
* fields: rel-L2 <= 1e-5. The elementwise arithmetic is the same sequence;
  only the last bits differ.
* reduced dots <a, b>: |got - want| <= 1e-4 * ||a|| ||b||, the Cauchy-Schwarz
  scale of a float32 dot: the summation order differs, and some dots are
  near zero.
* the ghost copy is a copy: bit-identical.

The port's one pass1 kernel covers both TPU geometries, so its plain
version is held against the y-slab kernel (`_pass1y_call`) and the z-by-y
brick kernel (`_pass1zy_call`). The CUDA kernels themselves are checked
against these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu.ops.pallas import lanczos3d_pipe as j3
from nlsolvers_tpu.ops.pallas.bc3d import neumann_bc_planar_3d as jbc3d
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import bc3d as tb
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3

torch.set_num_threads(1)

FIELD_TOL = 1e-5
DOT_TOL = 1e-4
P = 2
MODES = ["reference", "clean", "aniso"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _descs(mode, shape, seed=3):
    """(JAX descriptor, port descriptor) of one operator mode on `shape`."""
    dx = 2.0 * 5.0 / (shape[-1] - 1)
    if mode == "aniso":
        c = (1.0 + 0.4 * np.random.default_rng(seed).random(shape)).astype(
            np.float32)
        return (jops.anisotropic_laplacian_3d(c, dx)._pallas_desc,
                tops.anisotropic_laplacian_3d(c, dx, device="cpu").kernel_desc)
    return (jops.laplacian_3d(shape, dx, variant=mode,
                              dtype=jnp.float32)._pallas_desc,
            tops.laplacian_3d(shape, dx, variant=mode,
                              device="cpu").kernel_desc)


def _fields(k, shape, seed):
    nz, ny, nx = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((P, nz * ny, nx)).astype(np.float32)
            for _ in range(k)]


def _check_dots(got, want, lefts, right):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i, a in enumerate(lefts):
        scale = np.linalg.norm(a) * np.linalg.norm(right)
        assert np.abs(got[i] - want[i]).max() <= DOT_TOL * scale, i


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _pallas_pass1(j, mode, shape, jdesc, scal, W, brick=None):
    """JAX pass1 in interpret mode: the y-slab kernel, or with brick =
    (tz, ty) the z-by-y brick kernel; inputs as lanczos_twopass3d_y builds
    them."""
    nz, ny, nx = shape
    kmode = "aniso3d" if mode == "aniso" else "iso3d"
    as4 = lambda a: jnp.asarray(a).reshape(P, nz, ny, nx)
    ty = brick[1] if brick else j3.pick_ty3d(nz, ny, nx, j, P,
                                             4 if mode == "aniso" else 0)
    w4 = as4(W[j])
    halos = j3.gather_y_halos(w4, ty, "seam" if mode == "aniso" else mode)
    args = [jnp.asarray(scal), w4, halos] + ([w4, w4] if brick else [])
    if mode == "aniso":
        wx4, wy4, wz4 = (jnp.asarray(jdesc[k]).reshape(1, nz, ny, nx)
                         for k in ("wx", "wy", "wz"))
        args += [wx4, wy4, j3._gather_wy_halos(wy4, ty), wz4]
        args += [wz4] if brick else []
    args += [as4(a) for a in W[:j]]
    variant = "aniso" if mode == "aniso" else mode
    if brick:
        call = j3._pass1zy_call(j, P, nz, ny, nx, brick[0], ty,
                                jdesc["scale"], jdesc["sign"], variant, True,
                                kmode)
    else:
        call = j3._pass1y_call(j, P, nz, ny, nx, ty, jdesc["scale"],
                               jdesc["sign"], variant, True, kmode)
    w, raw = call(*args)
    return np.asarray(w).reshape(P, nz * ny, nx), np.asarray(raw)


@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("mode", MODES)
def test_pass1_ref_matches_pallas_yslab(mode, j):
    shape = (8, 16, 128)
    jdesc, tdesc = _descs(mode, shape)
    W = _fields(j + 1, shape, 10 + j)
    scal = np.array([[0.7, 0.3]], np.float32)
    w_j, raw_j = _pallas_pass1(j, mode, shape, jdesc, scal, W)
    w_t, raw_t = t3.pass1_3d_ref(torch.from_numpy(scal),
                                 torch.from_numpy(W[j]), _t(W[:j]), tdesc)
    assert _rel(w_t.numpy(), w_j) <= FIELD_TOL
    _check_dots(raw_t.numpy(), raw_j, W, w_j)


@pytest.mark.parametrize("mode", MODES)
def test_pass1_ref_matches_pallas_brick(mode):
    """The same function on the TPU's other geometry: 2 x 2 bricks of
    (tz, ty) = (8, 8), so both the z and the y halos cross bricks."""
    shape, j = (16, 16, 128), 2
    jdesc, tdesc = _descs(mode, shape)
    W = _fields(j + 1, shape, 20)
    scal = np.array([[0.6, -0.2]], np.float32)
    w_j, raw_j = _pallas_pass1(j, mode, shape, jdesc, scal, W, brick=(8, 8))
    w_t, raw_t = t3.pass1_3d_ref(torch.from_numpy(scal),
                                 torch.from_numpy(W[j]), _t(W[:j]), tdesc)
    assert _rel(w_t.numpy(), w_j) <= FIELD_TOL
    _check_dots(raw_t.numpy(), raw_j, W, w_j)


@pytest.mark.parametrize("j", [0, 3])
def test_pass2_ref_matches_pallas(j):
    shape = (8, 16, 128)
    R, nx = shape[0] * shape[1], shape[2]
    w, *W = _fields(j + 2, shape, 30 + j)
    q = np.random.default_rng(4).uniform(-0.5, 0.5, (j + 1, 2)).astype(
        np.float32)
    tile = jl._pick_tile(R, nx, j + 4, nplanes=P)
    wn_j, nsq_j = jl._pass2_call(j, P, R, nx, tile, True)(
        jnp.asarray(q), jnp.asarray(w), *map(jnp.asarray, W))
    wn_t, nsq_t = t3.pass2_ref(torch.from_numpy(q), torch.from_numpy(w),
                               _t(W))
    assert _rel(wn_t.numpy(), wn_j) <= FIELD_TOL
    assert abs(float(nsq_t[0, 0]) - float(nsq_j[0, 0])) <= (
        FIELD_TOL * float(nsq_j[0, 0]))


@pytest.mark.parametrize("shape", [(16, 16, 128), (8, 24, 256)])
def test_bc3d_ref_matches_pallas(shape):
    """The shapes of tests/test_pallas.py's bc3d test; exact equality."""
    nz, ny, nx = shape
    up = np.random.default_rng(7).standard_normal(
        (P, nz * ny, nx)).astype(np.float32)
    want = np.asarray(jbc3d(jnp.asarray(up), shape, interpret=True))
    ut = torch.from_numpy(up.copy())
    got = tb.bc3d_ref(ut, shape)
    assert got is ut                                 # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_matfunc_planar_3d_matches_pallas(mode):
    """exp(i t L) u through the two-pass 3D loop and combine, at (16, 16,
    128) m=7, against JAX's planar matfunc (y-slab two-pass, interpret)."""
    shape, m, t = (16, 16, 128), 7, 1j * 1e-3
    jdesc, tdesc = _descs(mode, shape)
    (u,) = _fields(1, shape, 40)

    @jax.jit
    def pallas(uj):
        return jl.matfunc_apply_planar(uj, jdesc, np.complex64(t), "exp", m,
                                       interpret=True)

    want = np.asarray(pallas(jnp.asarray(u)))
    got = tl.matfunc_apply_planar(torch.from_numpy(u), tdesc, t, "exp", m)
    assert got.shape == (P, shape[0] * shape[1], shape[2])
    assert _rel(got.numpy(), want) <= FIELD_TOL


def test_cpu_tensors_never_launch_kernels():
    """Under kernel_mode "auto" a CPU tensor takes the plain versions; the
    launch counters count kernel launches only."""
    assert config.kernel_mode == "auto"
    counters = (t3.pass1_3d, t3.pass2, tl.combine, tb.neumann_bc_planar_3d)
    before = [f.launches for f in counters]
    shape = (5, 6, 7)
    _, tdesc = _descs("aniso", shape)
    (u,) = _fields(1, shape, 41)
    y = tl.matfunc_apply_planar(torch.from_numpy(u), tdesc, 1j * 1e-3, "exp",
                                5)
    tb.neumann_bc_planar_3d(y, shape)
    assert torch.isfinite(y).all()
    assert [f.launches for f in counters] == before


def test_zero_start_vector_stays_finite():
    """safe_inv keeps a zero start vector's columns at 0: f(L) 0 = 0."""
    shape = (4, 5, 6)
    _, tdesc = _descs("reference", shape)
    z = torch.zeros((P, 20, 6))
    W, s, a, b, b0 = tl.lanczos_planar(z, tdesc, 5)
    assert len(W) == 5 and all(float(x) == 0.0 for x in s)
    y = tl.matfunc_apply_planar(z, tdesc, 1j * 1e-3, "exp", 5)
    assert torch.isfinite(y).all() and not y.abs().max() > 0


def test_wrong_view_raises():
    """A field that is not the merged view of the descriptor's grid."""
    _, tdesc = _descs("reference", (4, 5, 6))
    with pytest.raises(NotImplementedError):
        tl.lanczos_planar(torch.zeros((P, 4, 30)), tdesc, 4)
    with pytest.raises(ValueError):
        tb.bc3d_ref(torch.zeros((P, 4, 30)), (4, 5, 6))
