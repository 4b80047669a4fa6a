"""The port's grid-sharded 3D SS2 step against the JAX package's.

As tests/test_torch_sharded2d.py: JAX on the 8 virtual CPU devices of
tests/conftest.py inside shard_map, the port on a single-process mesh of
CPU shards (the plain versions of the shard kernels), the same seeded
numpy inputs for both.

Tolerances:
* sharded operators in float64: <= 1e-12; the ghost copy (the where-chain
  and bc3d_ref with offsets) exactly;
* pass1_shard3d_ref vs the Pallas K9 (_pass1y_shard_call), K10
  (_pass1y_shard_aniso_call), K11 (_pass1zy_shard_call), K12
  (_pass1zy_shard_aniso_call) and _pass1_call in modes shard3d and
  shard3d_aniso, in interpret mode with the same halos, offsets and face
  weights, float32: fields rel-L2 <= 1e-6, dots within 1e-6 of ||a|| ||b||
  (the summation order differs);
* the sharded step vs JAX's two routes: rtol 3e-4, atol 3e-5 (JAX's gate in
  tests/test_pallas.py); vs the port's unsharded planar step: rel-L2 <= 1e-5
  (deferred-norm CGS against the normalized two-pass loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as PS

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu.ops.pallas import lanczos3d_pipe as j3
from nlsolvers_tpu.ops.pallas.bc3d import neumann_bc_planar_3d as jbc3d
from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import boundaries as tbounds
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import bc3d as tb
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial

torch.set_num_threads(1)

AXES = ("gz", "gy", "gx")
FIELD_TOL = DOT_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_mesh(shape):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _port_mesh(shape):
    return tmesh.make_mesh(AXES, shape, devices=["cpu"] * int(np.prod(shape)))


def _shard_map(fn, mesh, n_in):
    spec = PS(*AXES)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in if n_in > 1 else spec,
        out_specs=spec, check_vma=False))


# ------------------------------------------------------------ sharded operators

@pytest.mark.parametrize("variant,mshape", [("clean", (2, 2, 2)),
                                            ("reference", (1, 1, 4))])
def test_sharded_operators_3d_match_jax(variant, mshape):
    shape, dx = (8, 12, 16), 0.1
    rng = np.random.default_rng(5)
    u = rng.standard_normal(shape)
    c = 1.0 + 0.4 * rng.random(shape)
    jm, tm = _jax_mesh(mshape), _port_mesh(mshape)
    ut, ct = shards.shard(u, tm), shards.shard(c, tm)
    want = np.asarray(_shard_map(jspatial.sharded_laplacian_3d(
        shape, dx, AXES, variant=variant, dtype=jnp.float64), jm, 1)(
        jnp.asarray(u)))
    got = shards.gather(tspatial._sharded_lap(shape, dx, tm, AXES, variant,
                                              torch.float64)(ut), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    full = tops.laplacian_3d(shape, dx, variant=variant, dtype=torch.float64,
                             device="cpu")
    np.testing.assert_allclose(got, full(torch.from_numpy(u)).numpy(),
                               rtol=1e-12, atol=1e-12)
    want = np.asarray(_shard_map(jspatial.sharded_anisotropic_laplacian_3d(
        shape, dx, AXES, variant=variant), jm, 2)(jnp.asarray(u),
                                                  jnp.asarray(c)))
    got = shards.gather(tspatial._sharded_aniso(shape, dx, tm, AXES,
                                                variant)(ut, ct), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    full = tops.anisotropic_laplacian_3d(c, dx, variant=variant, device="cpu")
    np.testing.assert_allclose(got, full(torch.from_numpy(u)).numpy(),
                               rtol=1e-12, atol=1e-12)
    want = np.asarray(_shard_map(jspatial.sharded_neumann_3d(shape, AXES),
                                 jm, 1)(jnp.asarray(u)))
    got = shards.gather(tspatial._sharded_neumann(shape, tm, AXES)(ut),
                        tm).numpy()
    assert np.array_equal(got, want)


def test_reference_operators_reject_split_y():
    tm = _port_mesh((1, 2, 2))
    parts = shards.shard(np.zeros((16, 16, 16)), tm)
    with pytest.raises(ValueError, match="reference"):
        tspatial.sharded_laplacian_3d((16, 16, 16), 0.1, tm, AXES,
                                      variant="reference")(parts)
    with pytest.raises(ValueError, match="reference"):
        tspatial.sharded_anisotropic_laplacian_3d(
            (16, 16, 16), 0.1, tm, AXES, variant="reference")(parts, parts)


@pytest.mark.parametrize("pos", [(0, 0, 0), (1, 1, 0), (2, 1, 1)])
def test_bc3d_ref_with_offsets_matches_pallas(pos):
    """bc3d_ref on one shard's block at its global offsets: exactly JAX's
    kernel, and exactly the unsharded ghost copy restricted to the block."""
    lshape, mshape, P = (4, 6, 8), (3, 2, 2), 2
    glob = tuple(a * b for a, b in zip(lshape, mshape))
    G = np.random.default_rng(6).standard_normal((P,) + glob).astype(
        np.float32)
    offs = tuple(p * n for p, n in zip(pos, lshape))
    sl = (slice(None),) + tuple(slice(o, o + n) for o, n in zip(offs, lshape))
    blk = np.ascontiguousarray(G[sl]).reshape(P, -1, lshape[2])
    want = np.asarray(jbc3d(jnp.asarray(blk), lshape, global_shape=glob,
                            offsets=offs, interpret=True))
    got = tb.bc3d_ref(torch.from_numpy(blk.copy()), lshape, glob, offs)
    assert np.array_equal(got.numpy(), want)
    whole = tbounds.neumann_no_velocity_3d(torch.from_numpy(G)).numpy()[sl]
    assert np.array_equal(got.numpy().reshape(whole.shape), whole)
    assert tb.neumann_bc_planar_3d.launches == 0


# ------------------------------------------------------------ K9-K12, K1'

LSHAPE, TILE, TZ = (4, 16, 16), 8, 2


def _faces(c, variant):
    """The global +x, +y, +z face weights of c (NZ, NY, NX), 0 on the
    domain's no-flux faces; +y on the merged rows under "reference"."""
    wx, wy, wz = (np.zeros_like(c) for _ in range(3))
    wx[..., :-1] = 0.5 * (c[..., :-1] + c[..., 1:])
    wz[:-1] = 0.5 * (c[:-1] + c[1:])
    if variant == "reference":
        cm = c.reshape(-1, c.shape[2])
        wym = np.zeros_like(cm)
        wym[:-1] = 0.5 * (cm[:-1] + cm[1:])
        wy = wym.reshape(c.shape)
    else:
        wy[:, :-1] = 0.5 * (c[:, :-1] + c[:, 1:])
    return wx, wy, wz


def _shard_inputs(G, pos, variant, c):
    """Shard `pos`'s merged block of the global planar field G
    (P, NZ, NY, NX), its halos in the port's layout (yh, zh, xh), its
    offsets and, given c, its operator weights."""
    P, NZ, NY, NX = G.shape
    nz, ny, nx = LSHAPE
    z0, y0, x0 = (p * n for p, n in zip(pos, LSHAPE))
    zs, ys, xs = (slice(o, o + n) for o, n in zip((z0, y0, x0), LSHAPE))
    blk = G[:, zs, ys, xs]
    zero = lambda *s: np.zeros((P,) + s, G.dtype)
    if variant == "reference":     # z, y whole: the merged seam rows
        top = np.concatenate([zero(1, nx), blk[:, :-1, -1]], 1)
        bot = np.concatenate([blk[:, 1:, 0], zero(1, nx)], 1)
    else:
        top = G[:, zs, y0 - 1, xs] if y0 > 0 else zero(nz, nx)
        bot = G[:, zs, y0 + ny, xs] if y0 + ny < NY else zero(nz, nx)
    zt = G[:, z0 - 1, ys, xs] if z0 > 0 else zero(ny, nx)
    zb = G[:, z0 + nz, ys, xs] if z0 + nz < NZ else zero(ny, nx)
    lf = G[:, zs, ys, x0 - 1] if x0 > 0 else zero(nz, ny)
    rt = G[:, zs, ys, x0 + nx] if x0 + nx < NX else zero(nz, ny)
    R = nz * ny
    out = dict(blk=np.ascontiguousarray(blk).reshape(P, R, nx),
               yh=np.stack([top, bot], 1), zh=np.stack([zt, zb], 1),
               xh=np.stack([lf, rt], 1).reshape(P, 2, R), offs=(z0, y0, x0))
    if c is not None:
        wx, wy, wz = _faces(c, variant)
        f = lambda a: np.ascontiguousarray(a[zs, ys, xs]).reshape(R, nx)
        out["w"] = dict(
            wx=f(wx), wy=f(wy), wz=f(wz),
            wxl=(wx[zs, ys, x0 - 1] if x0 > 0 else np.zeros((nz, ny),
                                                            c.dtype)
                 ).reshape(R),
            wyh=(wy[zs, y0 - 1, xs] if y0 > 0 else
                 np.concatenate([np.zeros((1, nx), c.dtype),
                                 wy[z0:z0 + nz - 1, NY - 1, xs]])
                 if variant == "reference" else np.zeros((nz, nx), c.dtype)),
            wzh=wz[z0 - 1, ys, xs] if z0 > 0 else np.zeros((ny, nx),
                                                           c.dtype))
    return out


def _pallas(kernel, j, sh, blks, glob, variant, scale, scal):
    """The Pallas kernel `kernel` on the shard inputs `sh`, the halos and
    weights put into its own layouts."""
    P, R, nx = sh["blk"].shape
    nz, ny = LSHAPE[:2]
    w4 = jnp.asarray(sh["blk"]).reshape(P, nz, ny, nx)
    W4 = [jnp.asarray(b).reshape(P, nz, ny, nx) for b in blks]
    yh, zh, xh = (jnp.asarray(sh[k]) for k in ("yh", "zh", "xh"))
    hc4 = jnp.stack([xh[:, 0], xh[:, 1]], -1).reshape(P, nz, ny, 2)
    zht, zhb = zh[:, :1], zh[:, 1:]
    offs = jnp.asarray([sh["offs"]], jnp.int32)
    scal = jnp.asarray(scal)
    w = {k: jnp.asarray(v) for k, v in sh.get("w", {}).items()}
    aniso = "w" in sh
    if kernel in ("yslab", "brick"):
        ty = TILE
        nblk = ny // ty
        h = j3.gather_y_halos(w4, ty, "clean")
        h = h.at[:, :, 0, 0, :].set(yh[:, 0]).at[:, :, nblk - 1, 1, :].set(
            yh[:, 1])
        if aniso:
            wx4, wy4, wz4 = (w[k].reshape(1, nz, ny, nx)
                             for k in ("wx", "wy", "wz"))
            ks = np.maximum(np.arange(nblk) * ty - 1, 0)
            wyh = jnp.take(wy4, jnp.asarray(ks), axis=2)
            wyh = wyh.at[:, :, 0, :].set(w["wyh"])[:, :, :, None, :]
            wzh4 = w["wzh"][None, None]
            wxl4 = w["wxl"].reshape(1, nz, ny, 1)
        if kernel == "yslab" and not aniso:
            call = j3._pass1y_shard_call(j, P, nz, ny, nx, ty, scale, 1.0,
                                         *glob, variant, True)
            return call(scal, offs, w4, h, hc4, zht, zhb, *W4)
        if kernel == "yslab":
            call = j3._pass1y_shard_aniso_call(j, P, nz, ny, nx, ty, scale,
                                               1.0, True)
            return call(scal, w4, h, hc4, zht, zhb, wx4, wy4, wyh, wz4, wzh4,
                        wxl4, *W4)
        if not aniso:
            call = j3._pass1zy_shard_call(j, P, nz, ny, nx, TZ, ty, scale,
                                          1.0, *glob, variant, True)
            return call(scal, offs, w4, h, w4, w4, zht, zhb, hc4, *W4)
        call = j3._pass1zy_shard_aniso_call(j, P, nz, ny, nx, TZ, ty, scale,
                                            1.0, True)
        return call(scal, w4, h, w4, w4, zht, zhb, hc4, wx4, wy4, wyh, wz4,
                    wz4, wzh4, wxl4, *W4)
    # the row-tiled K1' modes on the merged view
    wj = jnp.asarray(sh["blk"])
    Kb, zs = ny // TILE, np.arange(nz)
    h = jl._gather_halo_rows(wj, TILE, R)
    h = h.at[:, zs * Kb, 0, :].set(yh[:, 0]).at[:, (zs + 1) * Kb - 1, 1,
                                                 :].set(yh[:, 1])
    hc = jnp.stack([xh[:, 0], xh[:, 1]], -1)
    Wm = [jnp.asarray(b) for b in blks]
    if not aniso:
        gz, gy, gx = (torch.from_numpy(o + np.arange(n).reshape(s)) for o, n, s
                      in zip(sh["offs"], LSHAPE,
                             ((-1, 1, 1), (1, -1, 1), (1, 1, -1))))
        diag = tops.boundary_diagonal((gz, gy, gx), glob, variant,
                                      torch.float32).reshape(1, R, nx)
        call = jl._pass1_call(j, P, R, nx, TILE, scale, 1.0, variant, True,
                              mode="shard3d", geom=(nz, ny))
        return call(scal, wj, h, hc, jnp.asarray(diag.numpy()), wj, wj,
                    zh[:, 0], zh[:, 1], *Wm)
    wyh = jl._gather_halo_rows(w["wy"][None], TILE, R, per_block=1)
    wyh = wyh.at[:, zs * Kb, 0, :].set(w["wyh"])
    call = jl._pass1_call(j, P, R, nx, TILE, scale, 1.0, variant, True,
                          mode="shard3d_aniso", geom=(nz, ny))
    return call(scal, wj, h, hc, w["wx"][None], w["wy"][None], wyh,
                w["wxl"][None, :, None], w["wz"][None], w["wz"][None], wj, wj,
                zh[:, 0], zh[:, 1], w["wzh"][None], *Wm)


@pytest.mark.parametrize("kernel", ["yslab", "brick", "rowtile"])
@pytest.mark.parametrize("aniso", [False, True], ids=["iso", "aniso"])
@pytest.mark.parametrize("variant,pos,j", [("clean", (1, 1, 1), 3),
                                           ("clean", (0, 2, 1), 0),
                                           ("reference", (0, 0, 2), 3)])
def test_pass1_shard3d_ref_matches_pallas(kernel, aniso, variant, pos, j):
    """K9 (yslab, iso), K10 (yslab, aniso), K11 (brick, iso), K12 (brick,
    aniso) and K1' shard3d / shard3d_aniso (rowtile), at an interior, an
    edge and (reference: z and y whole, a 1x1x3 mesh) a corner shard."""
    P, dx = 2, 0.1
    mshape = (3, 3, 3) if variant == "clean" else (1, 1, 3)
    glob = tuple(a * b for a, b in zip(LSHAPE, mshape))
    rng = np.random.default_rng(7 + j)
    Gs = [rng.standard_normal((P,) + glob).astype(np.float32)
          for _ in range(j + 1)]
    c = ((1.0 + 0.4 * rng.random(glob)).astype(np.float32) if aniso
         else None)
    ins = [_shard_inputs(g, pos, variant, c) for g in Gs]
    sh = ins[j]
    blks = [s["blk"] for s in ins[:j]]
    scale = 1.0 / dx ** 2
    scal = np.array([[0.7, 0.3]], np.float32)
    w_j, raw_j = _pallas(kernel, j, sh, blks, glob, variant, scale, scal)
    w_j = np.asarray(w_j).reshape(sh["blk"].shape)
    d = dict(kind="shard3d_aniso" if aniso else "shard3d", NZ=glob[0],
             NY=glob[1], NX=glob[2], lnz=LSHAPE[0], lny=LSHAPE[1],
             scale=scale, sign=1.0, variant=variant,
             **dict(zip(("z0", "y0", "x0"), sh["offs"])),
             **{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sh.get("w", {}).items()})
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    w_t, raw_t = t3.pass1_shard3d(t(scal), t(sh["blk"]), [t(b) for b in blks],
                                  t(sh["yh"]), t(sh["zh"]), t(sh["xh"]), d)
    assert _rel(w_t, w_j) <= FIELD_TOL
    for i, b in enumerate(blks + [sh["blk"]]):
        cs = np.linalg.norm(b) * np.linalg.norm(w_j)
        assert np.abs(raw_t[i].numpy() - np.asarray(raw_j)[i]).max() <= (
            DOT_TOL * cs)
    # and the restriction of the unsharded operator to the block
    full = (tops.anisotropic_laplacian_3d(c, dx, variant=variant,
                                          device="cpu") if aniso else
            tops.laplacian_3d(glob, dx, variant=variant, device="cpu"))
    R3 = glob[0] * glob[1]
    av = t3._stencil3d_ref(torch.from_numpy(Gs[j]).reshape(P, R3, glob[2]),
                           full.kernel_desc).reshape((P,) + glob)
    zs, ys, xs = (slice(o, o + n) for o, n in zip(sh["offs"], LSHAPE))
    want = 0.7 * av[:, zs, ys, xs].reshape(sh["blk"].shape)
    if j:
        want = want - 0.3 * torch.from_numpy(blks[-1])
    assert _rel(w_t, want) <= FIELD_TOL
    assert t3.pass1_shard3d.launches == 0


# ------------------------------------------------------------ the sharded step

M_KRY, LX, DT = 6, 5.0, 1e-3


def _run_jax(jm, shape, variant, use_c, args, pallas_mode):
    old = jconfig.pallas_mode
    jconfig.pallas_mode = pallas_mode
    try:
        step = jspatial.make_sharded_nlse_step(
            "cubic", shape, LX, DT, jm, axis_names=AXES, krylov_m=M_KRY,
            dtype=jnp.complex64, variant=variant, use_c=use_c)
        return np.asarray(step(*[jnp.asarray(a) for a in args]))
    finally:
        jconfig.pallas_mode = old


@pytest.mark.parametrize("shape,mshape,variant,use_c", [
    ((32, 32, 256), (2, 2, 2), "clean", False),
    ((32, 32, 256), (2, 2, 2), "clean", True),
    ((16, 16, 1024), (1, 1, 8), "reference", False)],
    ids=["clean-iso", "clean-aniso", "reference-x-only"])
def test_sharded_step_3d_matches_jax_and_unsharded(shape, mshape, variant,
                                                   use_c):
    """The shapes of tests/test_pallas.py's sharded 3D tests, m=6: the
    port's step against both of JAX's routes and the port's unsharded
    planar step."""
    rng = np.random.default_rng(51)
    u0 = 0.1 * rng.standard_normal((2,) + shape).astype(np.float32)
    mf = np.ones(shape, np.float32)
    c = (1.0 + 0.4 * rng.random(shape)).astype(np.float32)
    args = (u0, mf, c) if use_c else (u0, mf)
    jm, tm = _jax_mesh(mshape), _port_mesh(mshape)
    step = tspatial.make_sharded_nlse_step(
        "cubic", shape, LX, DT, tm, axis_names=AXES, krylov_m=M_KRY,
        variant=variant, use_c=use_c)
    got = shards.gather(step(*[shards.shard(a, tm) for a in args]),
                        tm).numpy()
    for mode in ("interpret", "off"):
        want = _run_jax(jm, shape, variant, use_c, args, mode)
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    prob = tproblems.nlse_problem("cubic", shape, LX, DT, m_field=mf,
                                  c_field=c if use_c else None,
                                  krylov_m=M_KRY, variant=variant,
                                  device="cpu")
    whole = prob.step(prob.init(u0), 1).reshape((2,) + shape).numpy()
    assert _rel(got, whole) <= 1e-5


@pytest.mark.parametrize("use_c", [False, True], ids=["iso", "aniso"])
def test_sharded_step_3d_without_bc_matches_jax(use_c):
    """apply_bc=False skips the ghost copy (bc3d per shard) on both sides:
    the port's step against JAX's with apply_bc=False (interpret mode) on
    the clean (2, 2, 2) case above, and unlike the step with the copy."""
    shape, mshape = (32, 32, 256), (2, 2, 2)
    rng = np.random.default_rng(53)
    u0 = 0.1 * rng.standard_normal((2,) + shape).astype(np.float32)
    mf = np.ones(shape, np.float32)
    c = (1.0 + 0.4 * rng.random(shape)).astype(np.float32)
    args = (u0, mf, c) if use_c else (u0, mf)
    jm, tm = _jax_mesh(mshape), _port_mesh(mshape)
    kw = dict(axis_names=AXES, krylov_m=M_KRY, variant="clean", use_c=use_c)
    parts = [shards.shard(a, tm) for a in args]
    got = shards.gather(tspatial.make_sharded_nlse_step(
        "cubic", shape, LX, DT, tm, apply_bc=False, **kw)(*parts),
        tm).numpy()
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        step = jspatial.make_sharded_nlse_step(
            "cubic", shape, LX, DT, jm, dtype=jnp.complex64, apply_bc=False,
            **kw)
        want = np.asarray(step(*[jnp.asarray(a) for a in args]))
    finally:
        jconfig.pallas_mode = old
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    with_bc = shards.gather(tspatial.make_sharded_nlse_step(
        "cubic", shape, LX, DT, tm, **kw)(*parts), tm).numpy()
    assert not np.array_equal(got[:, 0], with_bc[:, 0])   # the ghost plane
    inner = (slice(None),) + (slice(1, -1),) * 3
    np.testing.assert_array_equal(got[inner], with_bc[inner])


@pytest.mark.parametrize("use_c", [False, True], ids=["iso", "aniso"])
def test_sharded_step_3d_errors(use_c):
    """The reference variant with split y raises JAX's ValueError; so does
    a grid that does not divide over the mesh."""
    shape = (16, 16, 16)
    args = ((jnp.zeros((2,) + shape), jnp.ones(shape))
            + ((jnp.ones(shape),) if use_c else ()))
    jm, tm = _jax_mesh((1, 2, 2)), _port_mesh((1, 2, 2))
    with pytest.raises(ValueError, match="reference"):
        jspatial.make_sharded_nlse_step(
            "cubic", shape, LX, DT, jm, axis_names=AXES, krylov_m=M_KRY,
            variant="reference", use_c=use_c)(*args)
    with pytest.raises(ValueError, match="reference"):
        tspatial.make_sharded_nlse_step(
            "cubic", shape, LX, DT, tm, axis_names=AXES, krylov_m=M_KRY,
            variant="reference", use_c=use_c)
    with pytest.raises(ValueError):
        tspatial.make_sharded_nlse_step(
            "cubic", (16, 15, 16), LX, DT, tm, axis_names=AXES,
            variant="clean", use_c=use_c)
