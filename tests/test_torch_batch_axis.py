"""The port's batch axis against the JAX package's, on the CPU.

A mesh axis that splits no grid dimension splits the lanes of a batch: the
sharded steps and engines (parallel/spatial.py) run each batch index's grid
sub-mesh on its block of lanes, parallel/batch.py and the unsharded engine
(pipeline/engine.py) split the batch over the axis, Datagen pads the batch
to a multiple of it. JAX's side runs on the 8 virtual CPU devices of
tests/conftest.py (its generic psum'd Lanczos: no Pallas kernel on the
CPU), the port's on meshes whose shards all sit on the CPU. Inputs are made
with numpy from a seed and handed to both.

Gates:
* make_sharded_nlse_step with batch_axis on (batch, gy, gx) = (2, 2, 2),
  B = 4, complex128, m = 6 (JAX's test_sharded_with_batch_axis,
  tests/test_parallel.py:88-109): rtol 1e-10, atol 1e-12 against JAX's step
  and against each lane's unsharded nlse_problem;
* the same step on the complex64 planar path, c(x): JAX's sharded gate,
  rtol 2e-4, atol 2e-5, and each lane bit-equal to the lane run alone on
  the (2, 2) grid-only mesh (lane bits do not depend on the batch);
* make_sharded_realwave_step with batch_axis: float64 Gautschi (the generic
  path) and SV within 1e-12 of JAX's, float32 Gautschi (the shard kernels'
  plain versions) at rtol 2e-4, atol 2e-5;
* batched_evolve on a ("batch",) mesh of 2 (JAX's
  test_batched_evolve_matches_sequential): rtol 1e-9, atol 1e-12 against
  JAX's and the sequential problem, bit-equal without the mesh;
* the unsharded engines with a mesh: bit-equal to the engines without one
  (planar and complex NLSE, float32 and stochastic real-wave, the guard
  with a diverging lane and the series);
* the sharded engines with batch_axis: bit-equal to each lane block run on
  the grid-only mesh, and at JAX's gate against JAX's engine on the same
  mesh shape;
* Datagen with a (2,) or (2, 1, 2) batch mesh and batch_size 3 (one pad
  run per batch): the run id, archived ICs, c and file indices equal JAX's
  Datagen on the same mesh shape, u at JAX's sharded gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.parallel import batch as jbatch
from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu.pipeline import datagen as jdg
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.parallel import batch as tbatch
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial
from nlsolvers_tpu_torch.pipeline import datagen as tdg
from nlsolvers_tpu_torch.pipeline import engine as teng
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio

torch.set_num_threads(1)

N, LX, DT = 32, 4.0, 2e-3
AX2 = ("gy", "gx")
BAX2 = ("batch",) + AX2
F64 = dict(rtol=1e-10, atol=1e-12)
U_GATE = dict(rtol=2e-4, atol=2e-5)


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _port_mesh(shape, axes):
    return tmesh.make_mesh(axes, shape, devices=["cpu"] * int(np.prod(shape)))


def _inputs(B, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u0 = ((rng.standard_normal((B, N, N))
           + 1j * rng.standard_normal((B, N, N))) * 0.1)
    m = rng.uniform(0.5, 1.5, (B, N, N)).astype(dtype)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(dtype)
    return u0, m, c


# ------------------------------------------------------------ the sharded step

def test_sharded_step_batch_axis_complex128_matches_jax():
    """JAX's test_sharded_with_batch_axis on the port: (2, 2, 2), B = 4,
    complex128, m = 6, one step of 4 lanes, against JAX's step on the same
    inputs and each lane's unsharded nlse_problem."""
    B = 4
    u0, m, _ = _inputs(B, 11)
    up = np.stack([u0.real, u0.imag])                   # (2, B, N, N)
    jm = _jax_mesh((2, 2, 2), BAX2)
    jstep = jspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, jm, axis_names=AX2, batch_axis="batch",
        krylov_m=6, dtype=jnp.complex128)
    want = np.asarray(jstep(jnp.asarray(up), jnp.asarray(m)))
    tm = _port_mesh((2, 2, 2), BAX2)
    step = tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, tm, axis_names=AX2, batch_axis="batch",
        krylov_m=6, dtype=torch.complex128)
    parts = step(shards.shard(up, tm, AX2, "batch", batch_dim=1),
                 shards.shard(m, tm, AX2, "batch"))
    assert parts[0].shape == (2, 2, N // 2, N // 2)
    got = shards.gather(parts, tm, AX2, "batch", batch_dim=1).numpy()
    np.testing.assert_allclose(got, want, **F64)
    for b in range(B):
        prob = tproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=m[b],
                                      krylov_m=6, dtype=torch.complex128,
                                      device="cpu")
        ref = prob.step(prob.init(u0[b]), 1).numpy()
        np.testing.assert_allclose(got[0, b] + 1j * got[1, b], ref, **F64)


def test_sharded_step_batch_axis_planar_matches_jax_and_grid_mesh():
    """complex64 c(x) on (2, 2, 2), B = 4, m = 6, two steps: against JAX's
    step at the sharded gate; each lane bit-equal to the lane run alone on
    the (2, 2) grid-only mesh."""
    B = 4
    u0, m, c = _inputs(B, 12, np.float32)
    up = np.stack([u0.real, u0.imag]).astype(np.float32)
    jm = _jax_mesh((2, 2, 2), BAX2)
    jstep = jspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, jm, axis_names=AX2, batch_axis="batch",
        krylov_m=6, use_c=True)
    want = jnp.asarray(up)
    for _ in range(2):
        want = jstep(want, jnp.asarray(m), jnp.asarray(c))
    tm = _port_mesh((2, 2, 2), BAX2)
    step = tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, tm, axis_names=AX2, batch_axis="batch",
        krylov_m=6, use_c=True)
    s = shards.shard(up, tm, AX2, "batch", batch_dim=1)
    mp, cp = (shards.shard(a, tm, AX2, "batch") for a in (m, c))
    for _ in range(2):
        s = step(s, mp, cp)
    got = shards.gather(s, tm, AX2, "batch", batch_dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **U_GATE)
    gm = _port_mesh((2, 2), AX2)
    gstep = tspatial.make_sharded_nlse_step(
        "cubic", (N, N), LX, DT, gm, krylov_m=6, use_c=True)
    for b in range(B):
        g = shards.shard(up[:, b], gm)
        gmp, gcp = shards.shard(m[b], gm), shards.shard(c[b], gm)
        for _ in range(2):
            g = gstep(g, gmp, gcp)
        assert torch.equal(got[:, b], shards.gather(g, gm))


@pytest.mark.parametrize("integrator,f64", [("gautschi", True),
                                            ("sv", True),
                                            ("gautschi", False)])
def test_sharded_realwave_step_batch_axis_matches_jax(integrator, f64):
    """make_sharded_realwave_step with batch_axis, (2, 2, 2), B = 4, c(x)
    Klein-Gordon: float64 Gautschi (generic path) and SV within 1e-12 of
    JAX's step, float32 Gautschi (shard kernels) at the u gate."""
    B = 4
    npdt = np.float64 if f64 else np.float32
    rng = np.random.default_rng(13)
    u = (0.2 * rng.standard_normal((B, N, N))).astype(npdt)
    up = (u + 0.01 * rng.standard_normal((B, N, N))).astype(npdt)
    m = (1.0 + 0.1 * rng.random((B, N, N))).astype(npdt)
    c = (1.0 + 0.3 * rng.random((B, N, N))).astype(npdt)
    jstep = jspatial.make_sharded_realwave_step(
        "klein_gordon", (N, N), LX, DT, _jax_mesh((2, 2, 2), BAX2),
        axis_names=AX2, batch_axis="batch", integrator=integrator,
        krylov_m=6, dtype=jnp.float64 if f64 else jnp.float32, use_c=True)
    jn, jo = (np.asarray(a) for a in jstep(u, up, m, c))
    tm = _port_mesh((2, 2, 2), BAX2)
    tstep = tspatial.make_sharded_realwave_step(
        "klein_gordon", (N, N), LX, DT, tm, axis_names=AX2,
        batch_axis="batch", integrator=integrator, krylov_m=6,
        dtype=torch.float64 if f64 else torch.float32, use_c=True)
    tn, to = (shards.gather(x, tm, AX2, "batch").numpy() for x in tstep(
        *(shards.shard(a, tm, AX2, "batch") for a in (u, up, m, c))))
    np.testing.assert_array_equal(to, u)
    np.testing.assert_array_equal(jo, u)
    if f64:
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(tn, jn, **U_GATE)


# ------------------------------------------------------------ batch.py

def test_batched_evolve_matches_jax_and_sequential():
    """JAX's test_batched_evolve_matches_sequential: B = 4 complex128
    lanes on a ("batch",) mesh of 2, 3 snapshots every 2 steps."""
    B = 4
    u0, _, _ = _inputs(B, 14)
    m = np.ones((N, N))
    jprob = jproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=m,
                                   krylov_m=6, dtype=jnp.complex128)
    jm = _jax_mesh((2,), ("batch",))
    want = np.asarray(jbatch.batched_evolve(
        jprob, jax.vmap(jprob.init)(jnp.asarray(u0)), num_snapshots=3,
        snapshot_freq=2, mesh=jm))
    prob = tproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=m,
                                  krylov_m=6, dtype=torch.complex128,
                                  device="cpu")
    states0 = torch.stack([prob.init(u) for u in u0])
    mesh = _port_mesh((2,), ("batch",))
    got = tbatch.batched_evolve(prob, states0, num_snapshots=3,
                                snapshot_freq=2, mesh=mesh)
    assert got.shape == want.shape == (B, 3, N, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    assert torch.equal(got, tbatch.batched_evolve(prob, states0, 3, 2))
    for b in range(B):
        st = prob.init(u0[b])
        for i in range(4):
            st = prob.step(st, i + 1)
        np.testing.assert_allclose(got[b, 2].numpy(), st.numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_batched_step_planar_and_shard_batch():
    """batched_step of a complex64 c(x) problem takes its batched planar
    step (one step of B lanes), each lane bit-equal to the problem's step
    alone; sEWI's two-step state too. shard_batch places each lane block
    on its batch index's shards, replicated over the other axes, and a
    batch the axis does not divide raises."""
    u0, m, c = _inputs(3, 15, np.float32)
    for integ in ("ss2", "sewi"):
        prob = tproblems.nlse_problem("cubic", (N, N), LX, DT, m_field=m[0],
                                      c_field=c[0], krylov_m=6,
                                      integrator=integ, device="cpu")
        assert prob.meta["planar_state"] and prob.step.batched
        lanes = [prob.init(u) for u in u0]
        states = (torch.stack(lanes) if integ == "ss2" else
                  tuple(torch.stack([s[k] for s in lanes]) for k in (0, 1)))
        step = tbatch.batched_step(prob)
        for i in (1, 2):
            states = step(states, i)
            lanes = [prob.step(s, i) for s in lanes]
        first = states if integ == "ss2" else states[0]
        for b, s in enumerate(lanes):
            assert torch.equal(first[b], s if integ == "ss2" else s[0])
    mesh = _port_mesh((2, 2), ("batch", "gy"))
    x = torch.arange(4.0)
    put = tbatch.shard_batch({"x": x}, mesh)["x"]
    assert [p.tolist() for p in put] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    with pytest.raises(ValueError, match="not divisible"):
        tbatch.shard_batch(torch.zeros(3), mesh)


# ------------------------------------------------------------ the engines

@pytest.mark.parametrize("family,kw", [
    ("nlse", dict(dtype=torch.complex64)),
    ("nlse", dict(dtype=torch.complex128, integrator="sewi")),
    ("realwave", dict(dtype=torch.float32)),
    ("realwave", dict(kind="stochastic_phi4", integrator="sv",
                      noise_strength=0.1, seed=3))])
def test_unsharded_engine_mesh_bit_equal(family, kw):
    """The unsharded engines with a ("batch",) mesh of 2 (lane blocks of 2)
    equal the engines without one bit for bit, the guard's bad_at (one
    lane diverging) and the mass / energy series included."""
    B = 4
    mesh = _port_mesh((2,), ("batch",))
    u0, m, c = _inputs(B, 16)
    kw = dict(kw)
    if family == "nlse":
        packed = np.stack([u0.real, u0.imag], axis=1)
        packed[2] = np.nan                     # a lane of the second block
        args = (packed, m, c)
        make = lambda **k: teng.make_nlse_trajectory_fn(
            "cubic", (N, N), LX, DT, krylov_m=6, device="cpu", guard=True,
            record_energy=True, **kw, **k)
    else:
        kind = kw.pop("kind", "sine_gordon")
        u = 0.3 * u0.real
        u[1] = np.nan
        args = (u, 0.1 * u0.imag, m, c)
        make = lambda **k: teng.make_realwave_trajectory_fn(
            kind, (N, N), LX, DT, krylov_m=6, device="cpu", guard=True,
            record_energy=True, **kw, **k)
    want = make()(*args, 3, 2)
    got = make(mesh=mesh)(*args, 3, 2)
    flat = lambda out: [x for o in out for x in (
        o.values() if isinstance(o, dict) else [o])]
    for g, w in zip(flat(got), flat(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    bad = got[-2].tolist()
    assert bad[2 if family == "nlse" else 1] == 0 and bad[0] == 3


@pytest.mark.parametrize("generic", [False, True])
def test_sharded_engine_batch_axis(generic):
    """make_sharded_nlse_trajectory_fn with batch_axis on (2, 1, 2), B = 4,
    c(x), sEWI: each lane block bit-equal to the engine on the (1, 2)
    grid-only mesh, and at JAX's gate against JAX's engine on the same
    mesh shape (complex64: the planar path; complex128: the generic one,
    rtol 1e-10)."""
    B = 4
    u0, m, c = _inputs(B, 17)
    dt = np.float64 if generic else np.float32
    packed = np.stack([u0.real, u0.imag], axis=1).astype(dt)
    m, c = m.astype(dt), c.astype(dt)
    kw = dict(integrator="sewi", krylov_m=6, guard=True, record_energy=True)
    tm = _port_mesh((2, 1, 2), BAX2)
    tdtype = torch.complex128 if generic else torch.complex64
    got = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, tm, batch_axis="batch", dtype=tdtype,
        **kw)(packed, m, c, 3, 2)
    assert got[0].shape == (B, 3, 2, N, N)
    grid = tspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, _port_mesh((1, 2), AX2), dtype=tdtype,
        **kw)
    for sl in (slice(0, 2), slice(2, 4)):
        alone = grid(packed[sl], m[sl], c[sl], 3, 2)
        assert torch.equal(got[0][sl], alone[0])
        assert torch.equal(got[1][sl], alone[1])
        assert torch.equal(got[2]["mass"][sl], alone[2]["mass"])
    want = jspatial.make_sharded_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, _jax_mesh((2, 1, 2), BAX2),
        axis_names=AX2, batch_axis="batch",
        dtype=jnp.complex128 if generic else jnp.complex64, **kw)(
        packed, m, c, 3, 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **(F64 if generic else U_GATE))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------------ Datagen

def _cfg(mod, tmp, **kw):
    base = dict(family="nlse", phenomenon="multi_soliton", system="cubic",
                nx=N, Lx=5.0, T=0.01, nt=10, snapshots=3, num_runs=6,
                batch_size=3, anisotropy_type="periodic_structure",
                m_type="piecewise", krylov_m=6, seed=11, resume=True,
                output_dir=str(tmp))
    if mod is tdg:
        base["device"] = "cpu"
    base.update(kw)
    return mod.DatagenConfig(**base)


@pytest.mark.parametrize("shard_grid", [(), (1, 2)])
def test_datagen_batch_mesh_matches_jax(tmp_path, shard_grid):
    """Datagen with a batch mesh of 2 (and, with shard_grid, a (2, 1, 2)
    (batch, gy, gx) mesh), 6 runs in batches of 3: one pad run per batch,
    drawn and evolved, not archived. The run id, file names, ICs and c
    equal JAX's Datagen on the same mesh shape; u at JAX's sharded gate.
    The pad draws shift the second batch's ICs against the sweep without
    a mesh, as in JAX."""
    if shard_grid:
        tm, jm = _port_mesh((2,) + shard_grid, BAX2), _jax_mesh(
            (2,) + shard_grid, BAX2)
    else:
        tm, jm = _port_mesh((2,), ("batch",)), _jax_mesh((2,), ("batch",))
    td = tdg.Datagen(_cfg(tdg, tmp_path / "port", mesh=tm,
                          shard_grid=shard_grid))
    got = td.run()
    jd = jdg.Datagen(_cfg(jdg, tmp_path / "jax", mesh=jm,
                          shard_grid=shard_grid))
    want = jd.run()
    assert td.run_id == jd.run_id
    assert [p.name for p in got] == [p.name for p in want]
    assert [int(p.stem.rsplit("_", 1)[1]) for p in got] == list(range(6))
    for gp, jp in zip(got, want):
        g, j = tio.load_run(gp), tio.load_run(jp)
        np.testing.assert_array_equal(g["u0"], j["u0"])
        np.testing.assert_array_equal(g["c"], j["c"])
        np.testing.assert_allclose(g["u"], j["u"], **U_GATE)
    ref = tdg.Datagen(_cfg(tdg, tmp_path / "ref")).run()
    u0 = lambda p: tio.load_run(p)["u0"]
    assert all(np.array_equal(u0(g), u0(r)) for g, r in zip(got[:3],
                                                             ref[:3]))
    assert not np.array_equal(u0(got[3]), u0(ref[3]))


def test_cli_shard_batch_equals_unsharded(tmp_path):
    """The CLI with --shard-batch 2 (a ("batch",) mesh of 2 on --device
    cpu) archives the same files and trajectories, bit for bit, as the
    sweep without a mesh (4 runs in one batch, no pad; a lane's bits do not
    depend on its block); with --shard-batch 2 --shard-grid 1,2 the same
    run indices (the run id's digest holds shard_grid, as JAX's) and
    trajectories at the sharded gate."""
    from nlsolvers_tpu_torch.pipeline import __main__ as tcli

    base = ["nlse", "--phenomenon", "multi_soliton", "--nx", str(N),
            "--T", "0.01", "--nt", "4", "--snapshots", "3", "--num-runs",
            "4", "--krylov-m", "6", "--seed", "3", "--resume", "--device",
            "cpu", "--format", "npy"]
    runs = {}
    for name, flag in (("none", []), ("batch", ["--shard-batch", "2"]),
                       ("both", ["--shard-batch", "2", "--shard-grid",
                                 "1,2"])):
        out = tmp_path / name
        assert tcli.main(base + flag + ["--output-dir", str(out)]) == 0
        runs[name] = sorted((out / "npy").glob("run_*_u.npy"))
    assert [p.name for p in runs["batch"]] == [p.name for p in runs["none"]]
    idx = lambda ps: [p.name.split("_")[-2] for p in ps]
    assert idx(runs["both"]) == idx(runs["none"]) == ["0000", "0001",
                                                      "0002", "0003"]
    for a, b, c in zip(runs["none"], runs["batch"], runs["both"]):
        np.testing.assert_array_equal(np.load(b), np.load(a))
        np.testing.assert_allclose(np.load(c), np.load(a), **U_GATE)
