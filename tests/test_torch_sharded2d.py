"""The port's grid-sharded 2D SS2 step against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py inside
shard_map; the port's side on a single-process mesh whose shards all sit on
the CPU (`devices=["cpu"] * k`), so its wrappers take the plain versions of
the shard kernels. Inputs are made with numpy from a seed and handed to
both.

Tolerances:
* sharded operators in float64: <= 1e-12 (the same arithmetic; the ghost
  copy is a copy and matches exactly);
* pass1_shard2d_ref vs the Pallas _pass1_call in modes shard2d and
  shard2d_aniso (interpret mode, the same halo inputs), float32: fields
  rel-L2 <= 1e-6, dots within 1e-6 of the Cauchy-Schwarz scale ||a|| ||b||
  (only the summation order differs);
* the sharded step vs JAX's, both of its routes (interpret mode, and
  pallas_mode "off", the psum'd generic Lanczos): JAX's own gate of
  tests/test_pallas.py, rtol 3e-4, atol 3e-5; vs the port's unsharded
  planar step on the same global grid: rel-L2 <= 1e-5 (the unsharded loop
  is the normalized pipelined one, the sharded the deferred-norm CGS: the
  same Krylov space, other rounding).
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
from nlsolvers_tpu.parallel import mesh as jmesh
from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial
from nlsolvers_tpu_torch.utils import interop

torch.set_num_threads(1)

AXES = ("gy", "gx")
FIELD_TOL = DOT_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_mesh(shape, axes=AXES):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _port_mesh(shape, axes=AXES):
    return tmesh.make_mesh(axes, shape, devices=["cpu"] * int(np.prod(shape)))


def _shard_map(fn, mesh, n_in):
    spec = PS(*mesh.axis_names)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in if n_in > 1 else spec,
        out_specs=spec, check_vma=False))


# ------------------------------------------------------------ mesh, collectives

def test_factor_devices_and_mesh():
    for n in range(1, 13):
        for dims in (1, 2, 3):
            assert tmesh.factor_devices(n, dims) == jmesh.factor_devices(
                n, dims)
    m = tmesh.make_mesh(("gz", "gy", "gx"), devices=["cpu"] * 8)
    assert m.shape == (2, 2, 2) and m.size == 8
    assert m.coords(5) == (1, 0, 1) and m.axis_index(5, "gx") == 1
    assert m.neighbor(5, "gz", -1) == 1 and m.neighbor(5, "gz", 1) is None
    like = interop.mesh_like(_jax_mesh((2, 2)), "cpu")
    assert like.shape == (2, 2) and like.axis_names == AXES
    with pytest.raises(ValueError):
        tmesh.make_mesh(AXES, (2, 3), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # nothing moves to the CPU
            tmesh.make_mesh(AXES)


def test_collectives_and_sharded_state():
    mesh = _port_mesh((2, 3))
    rng = np.random.default_rng(1)
    g = rng.standard_normal((2, 8, 9)).astype(np.float32)
    parts = shards.shard(g, mesh)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 3)] * 6
    assert all(p.is_contiguous() for p in parts)
    assert np.array_equal(shards.gather(parts, mesh).numpy(), g)
    # halo exchange along gx: the first shard of the axis receives zeros
    got = shards.recv_from_prev([p[..., -1] for p in parts], mesh, "gx")
    for k, h in enumerate(got):
        iy, ix = mesh.coords(k)
        want = (np.zeros((2, 4), np.float32) if ix == 0
                else g[:, 4 * iy:4 * iy + 4, 3 * ix - 1])
        assert np.array_equal(h.numpy(), want)
    got = shards.recv_from_next([p[..., 0, :] for p in parts], mesh, "gy")
    for k, h in enumerate(got):
        iy, ix = mesh.coords(k)
        want = (np.zeros((2, 3), np.float32) if iy == 1
                else g[:, 4, 3 * ix:3 * ix + 3])
        assert np.array_equal(h.numpy(), want)
    # psum: one sum in shard order, the same bits on every shard
    vals = [torch.tensor(float(v), dtype=torch.float32)
            for v in rng.standard_normal(6)]
    sums = shards.psum(vals, mesh)
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    assert all(torch.equal(s, acc) for s in sums)
    assert all(torch.equal(s, max(vals)) for s in shards.pmax(vals, mesh))
    with pytest.raises(ValueError):
        shards.shard(np.zeros((7, 9)), mesh)


# ------------------------------------------------------------ sharded operators

@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_sharded_laplacian_2d_matches_jax(variant):
    shape, mshape, dx = (16, 24), (2, 2), 0.1
    rng = np.random.default_rng(2)
    u = rng.standard_normal(shape)
    jm, tm = _jax_mesh(mshape), _port_mesh(mshape)
    want = np.asarray(_shard_map(jspatial.sharded_laplacian_2d(
        shape, dx, dx, AXES, variant=variant, dtype=jnp.float64), jm, 1)(
        jnp.asarray(u)))
    lap = tspatial.sharded_laplacian_2d(shape, dx, dx, tm, AXES,
                                        variant=variant, dtype=torch.float64)
    got = shards.gather(lap(shards.shard(u, tm)), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    full = tops.laplacian_2d(shape, dx, dx, variant=variant,
                             dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got, full(torch.from_numpy(u)).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_sharded_aniso_2d_and_neumann_match_jax():
    shape, mshape, dx = (16, 24), (2, 2), 0.1
    rng = np.random.default_rng(3)
    u = rng.standard_normal(shape)
    c = 1.0 + 0.4 * rng.random(shape)
    jm, tm = _jax_mesh(mshape), _port_mesh(mshape)
    want = np.asarray(_shard_map(jspatial.sharded_anisotropic_laplacian_2d(
        shape, dx, dx, AXES), jm, 2)(jnp.asarray(u), jnp.asarray(c)))
    op = tspatial._sharded_aniso(shape, dx, tm, AXES, "aniso")
    got = shards.gather(op(shards.shard(u, tm), shards.shard(c, tm)),
                        tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    full = tops.anisotropic_laplacian_2d(c, dx, dx, device="cpu")
    np.testing.assert_allclose(got, full(torch.from_numpy(u)).numpy(),
                               rtol=1e-12, atol=1e-12)
    # the ghost copy: exactly JAX's, in its update order
    want = np.asarray(_shard_map(jspatial.sharded_neumann_2d(shape, AXES),
                                 jm, 1)(jnp.asarray(u)))
    neu = tspatial._sharded_neumann(shape, tm, AXES)
    got = shards.gather(neu(shards.shard(u, tm)), tm).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------ K1' shard modes

def _block_and_halos(G, pos, lshape):
    """Shard `pos`'s block of the global planar field G (P, NY, NX) and its
    halos in the port's layout: yh (P, 2, lnx), xh (P, 2, lny)."""
    P, NY, NX = G.shape
    (lny, lnx), (iy, ix) = lshape, pos
    y0, x0 = iy * lny, ix * lnx
    blk = G[:, y0:y0 + lny, x0:x0 + lnx]
    zr, zc = np.zeros((P, lnx), G.dtype), np.zeros((P, lny), G.dtype)
    top = G[:, y0 - 1, x0:x0 + lnx] if y0 > 0 else zr
    bot = G[:, y0 + lny, x0:x0 + lnx] if y0 + lny < NY else zr
    lft = G[:, y0:y0 + lny, x0 - 1] if x0 > 0 else zc
    rgt = G[:, y0:y0 + lny, x0 + lnx] if x0 + lnx < NX else zc
    return (np.ascontiguousarray(blk), np.stack([top, bot], 1),
            np.stack([lft, rgt], 1), (y0, x0))


@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("pos,j", [((0, 0), 0), ((1, 1), 3), ((2, 1), 3)])
def test_pass1_shard2d_ref_matches_pallas(mode, pos, j):
    """Corner, interior and edge shards of a 3x3 mesh; K1' in interpret
    mode, given the same halos in its own layout."""
    P, lshape, mshape, tile = 2, (16, 24), (3, 3), 8
    NY, NX = lshape[0] * mshape[0], lshape[1] * mshape[1]
    dx = 0.1
    rng = np.random.default_rng(4)
    Gs = [rng.standard_normal((P, NY, NX)).astype(np.float32)
          for _ in range(j + 1)]
    cg = (1.0 + 0.4 * rng.random((NY, NX))).astype(np.float32)
    blks = [_block_and_halos(g, pos, lshape)[0] for g in Gs]
    wj, yh, xh, (y0, x0) = _block_and_halos(Gs[j], pos, lshape)
    lny, lnx = lshape
    nblk = lny // tile
    scal = np.array([[0.7, 0.3]], np.float32)
    scale = 1.0 / dx ** 2
    d = dict(kind="shard2d" if mode != "aniso" else "shard2d_aniso",
             NY=NY, NX=NX, y0=y0, x0=x0, scale=scale, sign=1.0,
             variant=mode)
    h = jl._gather_halo_rows(jnp.asarray(wj), tile, lny)
    h = h.at[:, 0, 0, :].set(yh[:, 0]).at[:, nblk - 1, 1, :].set(yh[:, 1])
    hc = jnp.asarray(np.ascontiguousarray(xh.transpose(0, 2, 1)))
    sl = (slice(y0, y0 + lny), slice(x0, x0 + lnx))
    if mode == "aniso":
        wx = np.zeros_like(cg)
        wx[:, :-1] = 0.5 * (cg[:, :-1] + cg[:, 1:])
        wy = np.zeros_like(cg)
        wy[:-1] = 0.5 * (cg[:-1] + cg[1:])
        wxl = wx[sl[0], x0 - 1] if x0 > 0 else np.zeros(lny, np.float32)
        wyh = wy[y0 - 1, sl[1]] if y0 > 0 else np.zeros(lnx, np.float32)
        wxp, wyp = wx[sl], wy[sl]
        d.update(wx=torch.from_numpy(np.ascontiguousarray(wxp)),
                 wy=torch.from_numpy(np.ascontiguousarray(wyp)),
                 wxl=torch.from_numpy(np.ascontiguousarray(wxl)),
                 wyh=torch.from_numpy(np.ascontiguousarray(wyh)))
        wyhj = jl._gather_halo_rows(jnp.asarray(wyp)[None], tile, lny,
                                    per_block=1).at[:, 0, 0, :].set(wyh)
        ops = (h, hc, jnp.asarray(wxp)[None], jnp.asarray(wyp)[None], wyhj,
               jnp.asarray(wxl)[None, :, None])
        jmode = "shard2d_aniso"
    else:
        gy = y0 + np.arange(lny)[:, None]
        gx = x0 + np.arange(lnx)[None, :]
        diag = tops.boundary_diagonal((torch.from_numpy(gy),
                                       torch.from_numpy(gx)), (NY, NX), mode,
                                      torch.float32)
        ops = (h, hc, jnp.asarray(diag.numpy())[None])
        jmode = "shard2d"
    call = jl._pass1_call(j, P, lny, lnx, tile, scale, 1.0, mode, True,
                          mode=jmode)
    w_j, raw_j = call(jnp.asarray(scal), jnp.asarray(wj), *ops,
                      *[jnp.asarray(b) for b in blks[:j]])
    w_t, raw_t = tl.pass1_shard2d(
        torch.from_numpy(scal), torch.from_numpy(wj),
        [torch.from_numpy(b) for b in blks[:j]],
        torch.from_numpy(np.ascontiguousarray(yh)),
        torch.from_numpy(np.ascontiguousarray(xh)), d)
    assert _rel(w_t, w_j) <= FIELD_TOL
    for i, b in enumerate(blks[:j] + [wj]):
        scale_cs = np.linalg.norm(b) * np.linalg.norm(np.asarray(w_j))
        assert np.abs(raw_t[i].numpy() - np.asarray(raw_j)[i]).max() <= (
            DOT_TOL * scale_cs)
    # and the restriction of the unsharded operator to the block
    full = (tops.anisotropic_laplacian_2d(cg, dx, dx, device="cpu")
            if mode == "aniso" else
            tops.laplacian_2d((NY, NX), dx, dx, variant=mode, device="cpu"))
    av = full.kernel_desc
    whole = tl._operator_ref(torch.from_numpy(Gs[j]), av)[:, sl[0], sl[1]]
    want = 0.7 * whole - (0.3 * torch.from_numpy(blks[j - 1]) if j else 0)
    assert _rel(w_t, want) <= FIELD_TOL
    assert tl.pass1_shard2d.launches == 0         # CPU: the plain version


# ------------------------------------------------------------ the sharded step

N, M_KRY, LX, DT = 256, 6, 5.0, 1e-3


def _jax_step(mesh, use_c, pallas_mode):
    old = jconfig.pallas_mode
    jconfig.pallas_mode = pallas_mode
    try:
        return jspatial.make_sharded_nlse_step(
            "cubic", (N, N), LX, DT, mesh, axis_names=AXES, krylov_m=M_KRY,
            dtype=jnp.complex64, use_c=use_c)
    finally:
        jconfig.pallas_mode = old


def _run_jax(step, args, pallas_mode):
    old = jconfig.pallas_mode
    jconfig.pallas_mode = pallas_mode
    try:
        return np.asarray(step(*[jnp.asarray(a) for a in args]))
    finally:
        jconfig.pallas_mode = old


@pytest.mark.parametrize("use_c", [False, True], ids=["iso", "aniso"])
def test_sharded_step_matches_jax_and_unsharded(use_c):
    """256^2 on a (2, 2) mesh, m=6, as tests/test_pallas.py's sharded tests:
    the port's step against both of JAX's routes, and against the port's
    unsharded planar step."""
    rng = np.random.default_rng(31)
    u0 = 0.1 * rng.standard_normal((2, N, N)).astype(np.float32)
    mf = np.ones((N, N), np.float32)
    c = (1.0 + 0.4 * rng.random((N, N))).astype(np.float32)
    args = (u0, mf, c) if use_c else (u0, mf)
    jm, tm = _jax_mesh((2, 2)), _port_mesh((2, 2))
    step = tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, tm, axis_names=AXES, krylov_m=M_KRY,
        use_c=use_c)
    before = (tl.pass1_shard2d.launches, t3.pass2.launches,
              tl.combine.launches)
    parts = step(*[shards.shard(a, tm) for a in args])
    assert [tuple(p.shape) for p in parts] == [(2, N // 2, N // 2)] * 4
    got = shards.gather(parts, tm).numpy()
    for mode in ("interpret", "off"):
        want = _run_jax(_jax_step(jm, use_c, mode), args, mode)
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    prob = tproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=mf,
                                  c_field=c if use_c else None,
                                  krylov_m=M_KRY, device="cpu")
    assert prob.meta["planar_state"]
    whole = prob.step(prob.init(u0), 1).numpy()
    assert _rel(got, whole) <= 1e-5
    assert (tl.pass1_shard2d.launches, t3.pass2.launches,
            tl.combine.launches) == before


@pytest.mark.parametrize("use_c", [False, True], ids=["iso", "aniso"])
def test_sharded_step_without_bc_matches_jax(use_c):
    """apply_bc=False skips the ghost copy on both sides: the port's step
    against JAX's with apply_bc=False (interpret mode) on the test above's
    grid and mesh, and unlike the step with the ghost copy."""
    rng = np.random.default_rng(37)
    u0 = 0.1 * rng.standard_normal((2, N, N)).astype(np.float32)
    mf = np.ones((N, N), np.float32)
    c = (1.0 + 0.4 * rng.random((N, N))).astype(np.float32)
    args = (u0, mf, c) if use_c else (u0, mf)
    jm, tm = _jax_mesh((2, 2)), _port_mesh((2, 2))
    kw = dict(axis_names=AXES, krylov_m=M_KRY, use_c=use_c)
    parts = [shards.shard(a, tm) for a in args]
    got = shards.gather(tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, tm, apply_bc=False, **kw)(*parts),
        tm).numpy()
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        jstep = jspatial.make_sharded_nlse_step(
            "cubic", (N, N), LX, DT, jm, dtype=jnp.complex64,
            apply_bc=False, **kw)
    finally:
        jconfig.pallas_mode = old
    want = _run_jax(jstep, args, "interpret")
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    with_bc = shards.gather(tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, tm, **kw)(*parts), tm).numpy()
    assert not np.array_equal(got[:, 0], with_bc[:, 0])   # the ghost row
    np.testing.assert_array_equal(got[:, 1:-1, 1:-1], with_bc[:, 1:-1, 1:-1])


def test_sharded_step_positional_arguments_bind_as_jax():
    """The parameters of make_sharded_nlse_step come in JAX's order, so
    apply_bc, reorth and use_c given by position bind as in JAX."""
    import inspect
    names = list(inspect.signature(tspatial.make_sharded_nlse_step).parameters)
    assert names == list(
        inspect.signature(jspatial.make_sharded_nlse_step).parameters)
    assert names[-3:] == ["apply_bc", "reorth", "use_c"]
    n = 32
    rng = np.random.default_rng(41)
    tm = _port_mesh((2, 2))
    u0 = 0.1 * rng.standard_normal((2, n, n)).astype(np.float32)
    mf = np.ones((n, n), np.float32)
    c = (1.0 + 0.4 * rng.random((n, n))).astype(np.float32)
    parts = [shards.shard(a, tm) for a in (u0, mf, c)]
    head = ("cubic", (n, n), LX, DT, tm, AXES, None, 1.0, -0.1, 1.0, M_KRY,
            torch.complex64, "reference")
    by_pos = tspatial.make_sharded_nlse_step(*head, False, True, True)
    by_kw = tspatial.make_sharded_nlse_step(*head, apply_bc=False,
                                            reorth=True, use_c=True)
    np.testing.assert_array_equal(shards.gather(by_pos(*parts), tm).numpy(),
                                  shards.gather(by_kw(*parts), tm).numpy())
    # reorth=False by position: the generic path, as by keyword
    np.testing.assert_array_equal(
        shards.gather(tspatial.make_sharded_nlse_step(
            *head, True, False, False)(*parts[:2]), tm).numpy(),
        shards.gather(tspatial.make_sharded_nlse_step(
            *head, apply_bc=True, reorth=False, use_c=False)(*parts[:2]),
            tm).numpy())


def test_sharded_step_errors():
    tm = _port_mesh((2, 2))
    with pytest.raises(ValueError):              # the grid does not divide
        tspatial.make_sharded_nlse_step("cubic", (30, 33), LX, DT, tm,
                                        axis_names=AXES)
    jm = _jax_mesh((2, 2))
    with pytest.raises(ValueError):
        jspatial.make_sharded_nlse_step("cubic", (30, 33), LX, DT, jm,
                                        axis_names=AXES)(
            jnp.zeros((2, 30, 33)), jnp.ones((30, 33)))
    for kw in (dict(batch_axis="batch"), dict(batch_axis="gy"),
               dict(dtype=torch.complex128, batch_axis="batch")):
        with pytest.raises(ValueError):          # no such batch axis
            tspatial.make_sharded_nlse_step("cubic", (32, 32), LX, DT, tm,
                                            axis_names=AXES, **kw)
