"""The port's grid-sharded engines and batched sharded step against the
JAX package's, on the CPU.

JAX's side runs inside shard_map on the 8 virtual CPU devices of
tests/conftest.py, on its generic psum'd Lanczos path (pallas_mode "auto"
takes no Pallas kernel on the CPU), as tests/test_parallel.py:395-460 runs
it; the port's side on a single-process mesh whose shards all sit on the
CPU, its wrappers taking the shard kernels' plain versions. Inputs are made
with numpy from a seed and handed to both.

Gates:
* the shard kernels' plain versions on a batch (B, ...) against B
  single-lane calls: bit for bit (the same elementwise arithmetic and the
  same per-lane sums);
* the sharded NLSE trajectory engine (SS2, Gautschi) against JAX's: JAX's
  gate of tests/test_parallel.py, u rtol 2e-4, atol 2e-5; sEWI and fused
  sEWI: rtol 3e-4, atol 3e-5 (tests/test_pallas.py's sEWI gate);
* the sharded real-wave engine (float32 Gautschi) against JAX's: u rtol
  2e-4, atol 2e-5, v = (u - u_past)/dt rtol 2e-3, atol 5e-3 (1/dt amplifies
  float32 rounding, tests/test_parallel.py:459-460);
* the float64 SV energy series, 2D on (2, 2) and 3D on (2, 2, 2) with the
  clean variant: rtol 1e-10 against JAX's sharded engine and the port's
  unsharded one, bad_at equal (tests/test_datagen.py:296-356);
* make_sharded_realwave_step against JAX's: SV float64 within 1e-12,
  Gautschi float32 at the u gate;
* the batched sharded step lane by lane: bit-equal to the same lane run
  alone (B = 1) and, for SS2, to make_sharded_nlse_step, and within
  rel-L2 2e-4 of the port's unsharded engine (the sharded-vs-unsharded gate
  of chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial
from nlsolvers_tpu_torch.pipeline import engine as teng

torch.set_num_threads(1)

N, LX, DT, B = 32, 5.0, 1e-3, 2
AX2, AX3 = ("gy", "gx"), ("gz", "gy", "gx")


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _port_mesh(shape, axes):
    return tmesh.make_mesh(axes, shape, devices=["cpu"] * int(np.prod(shape)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _nlse_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u0 = 0.1 * rng.standard_normal((B, 2) + shape).astype(np.float32)
    m = (1.0 + 0.1 * rng.random((B,) + shape)).astype(np.float32)
    c = (1.0 + 0.3 * rng.random((B,) + shape)).astype(np.float32)
    return u0, m, c


# ------------------------------------------------ the batched plain versions

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.mark.parametrize("mode", ["reference", "clean", "aniso"])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_shard_kernels_batched_equal_lanes(mode, P, dim):
    """pass1_shard2d_ref / pass1_shard3d_ref on B = 3 lanes of a block, each
    lane with its own halos and face weights, equal B single-lane calls bit
    for bit."""
    lanes = 3
    rng = np.random.default_rng(60 + P + dim)
    if dim == 2:
        ny, nx = 7, 9
        rows = ny
        hs = [_t(rng.standard_normal((lanes, P, 2, nx))),
              _t(rng.standard_normal((lanes, P, 2, ny)))]
        d = dict(kind="shard2d_aniso" if mode == "aniso" else "shard2d",
                 NY=3 * ny, NX=2 * nx, y0=ny, x0=0)
        wsh = (("wx", (ny, nx)), ("wy", (ny, nx)), ("wxl", (ny,)),
               ("wyh", (nx,)))
        kern = tl.pass1_shard2d
    else:
        nz, ny, nx = 3, 4, 9
        rows = nz * ny
        hs = [_t(rng.standard_normal((lanes, P, 2, nz, nx))),
              _t(rng.standard_normal((lanes, P, 2, ny, nx))),
              _t(rng.standard_normal((lanes, P, 2, rows)))]
        d = dict(kind="shard3d_aniso" if mode == "aniso" else "shard3d",
                 NZ=2 * nz, NY=ny, NX=3 * nx, z0=nz, y0=0, x0=nx, lnz=nz,
                 lny=ny)
        wsh = (("wx", (rows, nx)), ("wy", (rows, nx)), ("wz", (rows, nx)),
               ("wxl", (rows,)), ("wyh", (nz, nx)), ("wzh", (ny, nx)))
        kern = t3.pass1_shard3d
    d.update(scale=3.0, sign=-1.0 if P == 1 else 1.0, variant=mode)
    if mode == "aniso":
        d.update({k: _t(1.0 + 0.4 * rng.random((lanes,) + s))
                  for k, s in wsh})
    lane_d = [dict(d, **{k: d[k][b] for k, _ in wsh}) if mode == "aniso"
              else d for b in range(lanes)]
    W = [_t(rng.standard_normal((lanes, P, rows, nx))) for _ in range(5)]
    for j in (0, 4):
        scal = _t(rng.uniform(0.2, 1.0, (lanes, 1, 2)))
        got = kern(scal, W[j], W[:j], *hs, d)
        for b in range(lanes):
            want = kern(scal[b], W[j][b], [w[b] for w in W[:j]],
                        *[h[b] for h in hs], lane_d[b])
            assert all(torch.equal(x[b], y) for x, y in zip(got, want))


# ------------------------------------------------ the engines against JAX's

@pytest.mark.parametrize("integrator,gate", [
    ("ss2", (2e-4, 2e-5)), ("sewi", (3e-4, 3e-5)),
    ("sewi_fused", (3e-4, 3e-5)), ("gautschi", (2e-4, 2e-5))])
def test_sharded_nlse_engine_matches_jax(integrator, gate):
    """The sharded NLSE engine at 32^2 on (2, 4), B = 2, c(x), m = 6,
    against JAX's make_sharded_nlse_trajectory_fn on the same inputs."""
    u0, m, c = _nlse_inputs((N, N), 21)
    S, freq = 3, 2
    jfn = jspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, _jax_mesh((2, 4), AX2), axis_names=AX2,
        integrator=integrator, krylov_m=6, dtype=jnp.complex64)
    want = np.asarray(jfn(u0, m, c, S, freq))
    tfn = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, _port_mesh((2, 4), AX2),
        integrator=integrator, krylov_m=6)
    got = tfn(u0, m, c, S, freq).numpy()
    assert got.shape == want.shape == (B, S, 2, N, N)
    np.testing.assert_array_equal(got[:, 0], u0)
    np.testing.assert_allclose(got, want, rtol=gate[0], atol=gate[1])


def test_sharded_realwave_engine_matches_jax():
    """The sharded sine-Gordon Gautschi engine, float32, 32^2 on (2, 4),
    B = 2, m = 6, against JAX's make_sharded_realwave_trajectory_fn."""
    rng = np.random.default_rng(22)
    u0 = 0.2 * rng.standard_normal((B, N, N)).astype(np.float32)
    v0 = 0.05 * rng.standard_normal((B, N, N)).astype(np.float32)
    m = (1.0 + 0.1 * rng.random((B, N, N))).astype(np.float32)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(np.float32)
    jfn = jspatial.make_sharded_realwave_trajectory_fn(
        "sine_gordon", (N, N), LX, DT, _jax_mesh((2, 4), AX2),
        axis_names=AX2, integrator="gautschi", krylov_m=6,
        dtype=jnp.float32)
    ju, jv = (np.asarray(a) for a in jfn(u0, v0, m, c, 4, 2))
    tfn = tspatial.make_sharded_realwave_trajectory_fn(
        "sine_gordon", (N, N), LX, DT, _port_mesh((2, 4), AX2),
        integrator="gautschi", krylov_m=6)
    tu, tv = (a.numpy() for a in tfn(u0, v0, m, c, 4, 2))
    assert tu.shape == ju.shape == (B, 4, N, N)
    np.testing.assert_allclose(tu, ju, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tv, jv, rtol=2e-3, atol=5e-3)


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_sv_energy_matches_jax_and_unsharded(dim):
    """The float64 SV energy series (halo-aware gradients, psum'd sums),
    2D on (2, 2) and 3D on (2, 2, 2) with the clean variant, against JAX's
    sharded engine and the port's unsharded engine: rtol 1e-10, bad_at
    equal; the trajectories within 1e-12."""
    if dim == 2:
        shape, mshape, axes, kind, Bd = (N, N), (2, 2), AX2, "sine_gordon", 2
        rng = np.random.default_rng(5)
        m = (1.0 + 0.1 * rng.random((Bd,) + shape))
        c = (1.0 + 0.3 * rng.random((Bd,) + shape))
    else:
        shape, mshape, axes, kind, Bd = (16,) * 3, (2, 2, 2), AX3, \
            "klein_gordon", 1
        rng = np.random.default_rng(9)
        m = np.ones((Bd,) + shape)
        c = np.ones((Bd,) + shape)
    u0 = 0.3 * rng.standard_normal((Bd,) + shape)
    v0 = np.zeros_like(u0)
    kw = dict(integrator="sv", krylov_m=4, guard=True, record_energy=True,
              variant="clean")
    ju, _, jbad, jser = jspatial.make_sharded_realwave_trajectory_fn(
        kind, shape, LX, DT, _jax_mesh(mshape, axes), axis_names=axes,
        dtype=jnp.float64, **kw)(u0, v0, m, c, 3, 2)
    tfn = tspatial.make_sharded_realwave_trajectory_fn(
        kind, shape, LX, DT, _port_mesh(mshape, axes), axis_names=axes,
        dtype=torch.float64, **kw)
    tu, _, tbad, tser = tfn(u0, v0, m, c, 3, 2)
    ru, _, rbad, rser = teng.make_realwave_trajectory_fn(
        kind, shape, LX, DT, dtype=torch.float64, device="cpu", **kw)(
        u0, v0, m, c, 3, 2)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    np.testing.assert_array_equal(tbad.numpy(), rbad.numpy())
    np.testing.assert_allclose(tser["energy"].numpy(),
                               np.asarray(jser["energy"]), rtol=1e-10)
    np.testing.assert_allclose(tser["energy"].numpy(),
                               rser["energy"].numpy(), rtol=1e-10)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("integrator", ["sv", "gautschi"])
def test_sharded_realwave_step_matches_jax(integrator):
    """make_sharded_realwave_step, one step on sharded fields of a c(x)
    Klein-Gordon grid 32^2 on (2, 4): SV in float64 within 1e-12 of JAX's
    step, Gautschi in float32 at the u gate (JAX on its generic path)."""
    rng = np.random.default_rng(23)
    f64 = integrator == "sv"
    npdt = np.float64 if f64 else np.float32
    u = (0.2 * rng.standard_normal((N, N))).astype(npdt)
    up = (u + 0.01 * rng.standard_normal((N, N))).astype(npdt)
    m = (1.0 + 0.1 * rng.random((N, N))).astype(npdt)
    c = (1.0 + 0.3 * rng.random((N, N))).astype(npdt)
    jstep = jspatial.make_sharded_realwave_step(
        "klein_gordon", (N, N), LX, DT, _jax_mesh((2, 4), AX2),
        axis_names=AX2, integrator=integrator, krylov_m=6,
        dtype=jnp.float64 if f64 else jnp.float32, use_c=True)
    jn, jo = (np.asarray(a) for a in jstep(u, up, m, c))
    mesh = _port_mesh((2, 4), AX2)
    tstep = tspatial.make_sharded_realwave_step(
        "klein_gordon", (N, N), LX, DT, mesh, integrator=integrator,
        krylov_m=6, dtype=torch.float64 if f64 else torch.float32,
        use_c=True)
    tn, to = (shards.gather(x, mesh).numpy() for x in tstep(
        *(shards.shard(a, mesh) for a in (u, up, m, c))))
    np.testing.assert_array_equal(to, u)
    np.testing.assert_array_equal(jo, u)
    if f64:
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(tn, jn, rtol=2e-4, atol=2e-5)


# ------------------------------------------------ the batched sharded step

@pytest.mark.parametrize("integrator", ["ss2", "sewi", "gautschi"])
@pytest.mark.parametrize("dim", [2, 3])
def test_batched_sharded_step_equals_lanes_alone(integrator, dim):
    """The engine's batched sharded step, lane by lane: bit-equal to the
    lane run alone through the same engine (B = 1) and, for SS2, to
    make_sharded_nlse_step stepping the lane; within rel-L2 2e-4 of the
    port's unsharded engine."""
    if dim == 2:
        shape, mshape, axes, variant = (N, N), (2, 4), AX2, "reference"
    else:
        shape, mshape, axes, variant = (12, 12, 16), (1, 1, 4), AX3, \
            "reference"
    u0, m, c = _nlse_inputs(shape, 31 + dim)
    mesh = _port_mesh(mshape, axes)
    S, freq = 2, 3
    tfn = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", shape, LX, DT, mesh, axis_names=axes,
        integrator=integrator, krylov_m=6, variant=variant)
    got = tfn(u0, m, c, S, freq)
    ref = teng.make_nlse_trajectory_fn(
        "cubic", shape, LX, DT, integrator=integrator, krylov_m=6,
        variant=variant, device="cpu")(u0, m, c, S, freq)
    step = tspatial.make_sharded_nlse_step(
        "cubic", shape, LX, DT, mesh, axis_names=axes, krylov_m=6,
        variant=variant, use_c=True)
    for b in range(B):
        alone = tfn(u0[b:b + 1], m[b:b + 1], c[b:b + 1], S, freq)
        assert torch.equal(got[b], alone[0])
        assert _rel(got[b, -1], ref[b, -1]) <= 2e-4
        if integrator == "ss2":
            s = shards.shard(u0[b], mesh, axes)
            mp = shards.shard(m[b], mesh, axes)
            cp = shards.shard(c[b], mesh, axes)
            for _ in range(freq):
                s = step(s, mp, cp)
            assert torch.equal(got[b, -1], shards.gather(s, mesh, axes))


def test_sharded_engines_guard_and_mass():
    """guard + record_energy: bad_at (B,) at S for finite lanes and 0 for a
    NaN lane (whose snapshots stay NaN), the mass series the host mass of
    the returned snapshots within 1e-5."""
    u0, m, c = _nlse_inputs((N, N), 41)
    u0[1] = np.nan
    tfn = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, _port_mesh((2, 4), AX2), krylov_m=6,
        guard=True, record_energy=True)
    snaps, bad_at, series = tfn(u0, m, c, 3, 2)
    assert bad_at.tolist() == [3, 0]
    assert bool(torch.isfinite(snaps[0]).all())
    assert bool(torch.isnan(snaps[1, 0]).all())
    dx = 2 * LX / (N - 1)
    host = (snaps[0] ** 2).sum(dim=(1, 2, 3)) * dx * dx
    torch.testing.assert_close(series["mass"][0], host, rtol=1e-5, atol=0)


def test_sharded_arguments_for_later_slices_raise():
    """batch_axis on a mesh without that axis, or with a batch the axis
    does not divide, raises JAX's ValueError on every sharded step and
    engine (complex128, reorth=False and the float64 or reorth=False
    Gautschi run since the generic sharded path was ported);
    stochastic phi-4 and the 3D reference variant on split z or y raise
    JAX's ValueError."""
    mesh = _port_mesh((2, 4), AX2)
    mk = tspatial.make_sharded_nlse_trajectory_fn
    rw = tspatial.make_sharded_realwave_trajectory_fn
    for kw in (dict(), dict(dtype=torch.complex128), dict(reorth=False)):
        with pytest.raises(ValueError, match="batch axis"):
            mk("cubic", (N, N), LX, DT, mesh, batch_axis="batch", **kw)
    for kw in (dict(dtype=torch.float64), dict(reorth=False), dict()):
        with pytest.raises(ValueError, match="batch axis"):
            rw("sine_gordon", (N, N), LX, DT, mesh, batch_axis="batch",
               **kw)
    with pytest.raises(ValueError, match="batch axis"):
        tspatial.make_sharded_nlse_step("cubic", (N, N), LX, DT, mesh,
                                        batch_axis="batch")
    with pytest.raises(ValueError, match="batch axis"):
        tspatial.make_sharded_realwave_step("sine_gordon", (N, N), LX, DT,
                                            mesh, batch_axis="batch",
                                            dtype=torch.float64)
    bmesh = _port_mesh((2, 1, 2), ("batch",) + AX2)
    u0, m, c = _nlse_inputs((N, N), 3)
    traj = mk("cubic", (N, N), LX, DT, bmesh, batch_axis="batch",
              krylov_m=4)
    with pytest.raises(ValueError, match="not divisible"):
        traj(u0[:1], m[:1], c[:1], 2, 1)
    with pytest.raises(ValueError, match="stochastic_phi4"):
        rw("stochastic_phi4", (N, N), LX, DT, mesh)
    mesh3 = _port_mesh((2, 1, 2), AX3)
    with pytest.raises(ValueError, match="unsplit z"):
        mk("cubic", (8, 8, 8), LX, DT, mesh3, axis_names=AX3)
    with pytest.raises(ValueError, match="unsplit z"):
        rw("klein_gordon", (8, 8, 8), LX, DT, mesh3, axis_names=AX3,
           integrator="sv")
