"""The port's datagen engine, Datagen and CLI against the JAX package's.

Both engines run on the CPU; the port's with device="cpu", where its
wrappers take the kernels' plain versions (no launch is counted).

* make_nlse_trajectory_fn (ss2, sewi, gautschi) and
  make_realwave_trajectory_fn (gautschi, sv) in float64 at 32^2, B=2, c(x)
  and m(x) per lane: JAX's own gate (tests/test_datagen.py:45-86), rtol
  1e-10 / atol 1e-12 on u (1e-8 / 1e-10 on the real-wave velocity). Both
  sides take the complex (NLSE) or generic (real-wave) path there.
* complex64 c(x) SS2 and float32 sine-Gordon Gautschi at 128^2, B=2, m=6,
  2 snapshots: JAX with its Pallas kernels in interpret mode, as
  tests/test_pallas.py:731-756 runs them, and the port on its planar path
  with the plain versions; both sides on the planar / fused path (asserted),
  at the gates of the port's tests of those paths: rel-L2 <= 1e-5 per lane
  (tests/test_torch_aniso2d.py) and rtol 2e-5 / atol 2e-6
  (tests/test_torch_realwave.py).
* the guard: bad_at, the zero fill after the batch-wide exit and the
  snapshots before it equal JAX's (SV at an absurd dt; a Gautschi batch
  with one diverging lane, whose eigensolver failure the port turns into
  NaN as JAX's eigh does); the mass and energy series against JAX's.
* stochastic phi-4: one seed replays bit for bit, another seed and another
  lane differ (the noise is the port's, not JAX's).
* Datagen with JAX's config and seed: the same run id, file names,
  manifest, ICs, c, m and phenomenon params, trajectories at the float64
  gate, in hdf5 and npy; resume skips what JAX archived and redoes only
  what is missing; the CLI's main(argv) with --device cpu.
* the arguments of the batch axis: a mesh without it raises JAX's
  ValueError (Datagen, both engines), --shard-batch builds the (batch,)
  and (batch, *grid) meshes; device="cuda" with no card raises.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas.lanczos2d import supported_desc as j_supported
from nlsolvers_tpu.pipeline import datagen as jdg
from nlsolvers_tpu.pipeline import engine as jeng
from nlsolvers_tpu.pipeline import io_hdf5 as jio
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl
from nlsolvers_tpu_torch.pipeline import __main__ as tcli
from nlsolvers_tpu_torch.pipeline import datagen as tdg
from nlsolvers_tpu_torch.pipeline import engine as teng
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio

torch.set_num_threads(1)

N, LX, DT = 32, 5.0, 1e-3
SNAPS, FREQ = 4, 5
F64 = dict(rtol=1e-10, atol=1e-12)


def _fields(b, n=N, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m = 1.0 + 0.1 * rng.standard_normal((b, n, n))
    c = 1.0 + 0.1 * rng.standard_normal((b, n, n))
    return m.astype(dtype), c.astype(dtype)


def _ic(b, n=N, complex_=True, seed=1, dtype=np.float64):
    x = np.linspace(-LX, LX, n)
    out = []
    for i in range(b):
        env = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 + 0.5 * i))
        out.append(env * np.exp(1j * 0.3 * i * x[None, :]) if complex_
                   else env)
    out = np.stack(out)
    if complex_:
        return np.stack([out.real, out.imag], axis=1).astype(dtype)
    return out.astype(dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _counts():
    return [f.launches for f in (tl.pass1_iso2d, tl.pass1_aniso2d,
                                 tl.pipe_iso2d, tl.pipe_aniso2d, tl.combine)]


@pytest.mark.parametrize("integrator", ["ss2", "sewi", "gautschi"])
def test_nlse_engine_f64_matches_jax(integrator):
    m, c = _fields(2)
    u0 = _ic(2)
    kw = dict(integrator=integrator, krylov_m=6)
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, dtype=jnp.complex128, **kw)(
        u0, m, c, SNAPS, FREQ))
    fn = teng.make_nlse_trajectory_fn("cubic", (N, N), LX, DT,
                                      dtype=torch.complex128, device="cpu",
                                      **kw)
    assert not fn.planar                       # complex path, as JAX's
    got = _np(fn(u0, m, c, SNAPS, FREQ))
    assert got.shape == want.shape == (2, SNAPS, 2, N, N)
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("integrator", ["gautschi", "sv"])
def test_realwave_engine_f64_matches_jax(integrator):
    m, c = _fields(2, seed=2)
    u0 = _ic(2, complex_=False)
    v0 = 0.1 * _ic(2, complex_=False, seed=3)
    kw = dict(integrator=integrator, krylov_m=6)
    ju, jv = jeng.make_realwave_trajectory_fn(
        "sine_gordon", (N, N), LX, DT, dtype=jnp.float64, **kw)(
        u0, v0, m, c, SNAPS, FREQ)
    tu, tv = teng.make_realwave_trajectory_fn(
        "sine_gordon", (N, N), LX, DT, dtype=torch.float64, device="cpu",
        **kw)(u0, v0, m, c, SNAPS, FREQ)
    assert _np(tu).shape == (2, SNAPS, N, N)
    np.testing.assert_allclose(_np(tu), np.asarray(ju), **F64)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-8,
                               atol=1e-10)


def _jax_planar(shape, use_c):
    """JAX's engine gate (engine.py:121-131) under interpret mode."""
    dx = 2.0 * LX / (shape[-1] - 1)
    lap = (jops.anisotropic_laplacian_2d(jnp.ones(shape, jnp.float32), dx,
                                         dx) if use_c
           else jops.laplacian_2d(shape, dx, dx, dtype=jnp.float32))
    return bool(j_supported(lap._pallas_desc, shape, jnp.complex64))


@pytest.fixture
def jax_interpret():
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    yield
    jconfig.pallas_mode = old


def test_nlse_engine_planar_c_matches_jax_interpret(jax_interpret):
    n = 128
    m, c = _fields(2, n, seed=4, dtype=np.float32)
    c = (1.0 + 0.4 * np.random.default_rng(5).random((2, n, n))).astype(
        np.float32)
    u0 = _ic(2, n, dtype=np.float32)
    kw = dict(integrator="ss2", krylov_m=6)
    assert _jax_planar((n, n), True)
    want = np.asarray(jeng.make_nlse_trajectory_fn(
        "cubic", (n, n), LX, DT, dtype=jnp.complex64, **kw)(
        u0, m, c, 2, 2))
    fn = teng.make_nlse_trajectory_fn("cubic", (n, n), LX, DT,
                                      dtype=torch.complex64, device="cpu",
                                      **kw)
    assert fn.planar
    before = _counts()
    got = _np(fn(u0, m, c, 2, 2))
    assert _counts() == before                   # plain versions on the CPU
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for b in range(2):
        assert _rel(got[b, 1], want[b, 1]) <= 1e-5


def test_realwave_engine_f32_matches_jax_interpret(jax_interpret):
    n = 128
    x = np.linspace(-LX, LX, n, dtype=np.float32)
    u0 = np.stack([4 * np.arctan(np.exp(-(x[:, None] + 0.3 * b)))
                   * np.ones((n, n), np.float32) for b in range(2)])
    v0 = np.zeros_like(u0)
    m = (1.0 + 0.1 * np.random.default_rng(5).standard_normal(
        (2, n, n))).astype(np.float32)
    kw = dict(integrator="gautschi", krylov_m=6, use_c=False)
    assert _jax_planar((n, n), False)
    ju, jv = jeng.make_realwave_trajectory_fn(
        "sine_gordon", (n, n), LX, DT, dtype=jnp.float32, **kw)(
        u0, v0, m, None, 2, 2)
    before = _counts()
    tu, tv = teng.make_realwave_trajectory_fn(
        "sine_gordon", (n, n), LX, DT, dtype=torch.float32, device="cpu",
        **kw)(u0, v0, m, None, 2, 2)
    assert _counts() == before
    np.testing.assert_allclose(_np(tu), np.asarray(ju), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(_np(tv)[:, 0], np.asarray(jv)[:, 0])


def _guarded_pair(kind, integrator, u0, m, c, dt, snaps, freq):
    kw = dict(integrator=integrator, krylov_m=6, guard=True,
              record_energy=True)
    j = jeng.make_realwave_trajectory_fn(kind, (N, N), LX, dt,
                                         dtype=jnp.float64, **kw)(
        u0, np.zeros_like(u0), m, c, snaps, freq)
    t = teng.make_realwave_trajectory_fn(kind, (N, N), LX, dt,
                                         dtype=torch.float64, device="cpu",
                                         **kw)(
        u0, np.zeros_like(u0), m, c, snaps, freq)
    return [np.asarray(x) for x in j[:3]] + [np.asarray(j[3]["energy"])], \
        [_np(x) for x in t[:3]] + [_np(t[3]["energy"])]


def _guard_equal(j, t, snaps):
    (ju, jv, jbad, je), (tu, tv, tbad, te) = j, t
    assert tbad.dtype == np.int32
    np.testing.assert_array_equal(tbad, jbad)
    worst = int(jbad.max())
    for b in range(len(jbad)):
        k = int(jbad[b])                       # finite snapshots before it
        np.testing.assert_allclose(tu[b, :k], ju[b, :k], **F64)
        np.testing.assert_allclose(te[b, :k], je[b, :k], rtol=1e-10)
        if k < snaps:
            assert not np.isfinite(tu[b, k]).all()
            assert not np.isfinite(te[b, k])
    if worst < snaps:
        np.testing.assert_array_equal(tu[:, worst + 1:], 0.0)
        np.testing.assert_array_equal(ju[:, worst + 1:], 0.0)
        np.testing.assert_array_equal(tv[:, worst + 1:], 0.0)
    return worst


def test_guard_early_exit_matches_jax():
    """Both lanes diverge (SV at dt = 50, tests/test_datagen.py:436):
    bad_at, the zero fill and the energy series as JAX's."""
    m, c = _fields(2, seed=5)
    u0 = 5.0 * _ic(2, complex_=False)
    j, t = _guarded_pair("klein_gordon", "sv", u0, m, c, 50.0, 8, 2)
    assert (j[2] < 8).all()
    assert _guard_equal(j, t, 8) < 7


def test_guard_one_diverging_gautschi_lane_matches_jax():
    """phi-4 (focusing) Gautschi, lane 1 at 1e3 times lane 0's amplitude:
    lane 1 blows up, its eigensolver fails in the port (torch raises, JAX's
    eigh returns NaN), the lane turns NaN in both; lane 0 stays finite,
    equal to JAX's, and the run goes on to the end."""
    m, c = _fields(2, seed=6)
    u0 = 0.5 * _ic(2, complex_=False)
    u0[1] *= 1e3
    j, t = _guarded_pair("phi4", "gautschi", u0, m, c, 5e-2, 6, 2)
    assert j[2][0] == 6 and j[2][1] < 6
    _guard_equal(j, t, 6)


def test_mass_series_matches_jax():
    m, c = _fields(2)
    u0 = _ic(2)
    kw = dict(integrator="ss2", krylov_m=6, guard=True, record_energy=True)
    jo, jbad, js = jeng.make_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, dtype=jnp.complex128, **kw)(
        u0, m, c, SNAPS, FREQ)
    to, tbad, ts = teng.make_nlse_trajectory_fn(
        "cubic", (N, N), LX, DT, dtype=torch.complex128, device="cpu",
        **kw)(u0, m, c, SNAPS, FREQ)
    np.testing.assert_array_equal(_np(tbad), SNAPS)
    assert _np(ts["mass"]).shape == (2, SNAPS)
    np.testing.assert_allclose(_np(ts["mass"]), np.asarray(js["mass"]),
                               rtol=1e-10)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **F64)


def test_stochastic_replays_per_seed():
    m, _ = _fields(2, seed=4)
    u0 = _ic(2, complex_=False)
    v0 = np.zeros_like(u0)
    u0[1] = u0[0]

    def run(seed):
        return _np(teng.make_realwave_trajectory_fn(
            "stochastic_phi4", (N, N), LX, DT, noise_strength=0.1, seed=seed,
            dtype=torch.float64, use_c=False, device="cpu")(
            u0, v0, m, None, SNAPS, FREQ)[0])

    a, b, other = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, other)
    # the two lanes start alike in u0, not in m, and draw their own noise
    assert not np.allclose(a[0, -1], a[1, -1])


def _cfg(mod, tmp, **kw):
    base = dict(family="nlse", phenomenon="multi_soliton", system="cubic",
                nx=N, Lx=LX, T=0.01, nt=10, snapshots=3, num_runs=3,
                batch_size=2, anisotropy_type="layered", m_type="piecewise",
                krylov_m=6, seed=11, dtype="complex128", resume=True,
                record_energy=True, output_dir=str(tmp))
    if mod is tdg:
        base["device"] = "cpu"
    base.update(kw)
    return mod.DatagenConfig(**base)


def _npy_run(path):
    base = path.with_suffix("")
    out = {p.name[len(base.name) + 1:-4]: np.load(p)
           for p in base.parent.glob(f"{base.name}_*.npy")}
    out["meta"] = json.loads(path.read_text())
    return out


@pytest.mark.parametrize("family,fmt", [("nlse", "hdf5"), ("nlse", "npy"),
                                        ("realwave", "hdf5")])
def test_datagen_matches_jax(tmp_path, family, fmt):
    kw = dict(archive_format=fmt)
    if family == "realwave":
        kw.update(family="realwave", phenomenon="kink_field",
                  system="sine_gordon", dtype="float64")
    jd = jdg.Datagen(_cfg(jdg, tmp_path / "jax", **kw))
    td = tdg.Datagen(_cfg(tdg, tmp_path / "port", **kw))
    assert td.run_id == jd.run_id
    jw, tw = jd.run(), td.run()
    assert [p.name for p in tw] == [p.name for p in jw] and len(tw) == 3
    man = f"params_{td.run_id}.txt"
    assert (tmp_path / "port" / man).read_text() == \
        (tmp_path / "jax" / man).read_text()
    for jp, tp in zip(jw, tw):
        if fmt == "npy":
            j, t = _npy_run(jp), _npy_run(tp)
            j["meta"].pop("elapsed_time"), t["meta"].pop("elapsed_time")
            assert t["meta"] == j["meta"]
        else:
            j, t = jio.load_run(jp), tio.load_run(tp)
            for k in ("timestamp", "elapsed_time"):
                j["metadata"].pop(k), t["metadata"].pop(k)
            for k in ("metadata", "focusing", "grid", "time"):
                assert t[k] == j[k], k
        for k in j:
            if k == "v":             # JAX's velocity gate, as above
                np.testing.assert_allclose(t[k], j[k], rtol=1e-8, atol=1e-10)
            elif k in ("u", "mass", "energy"):
                np.testing.assert_allclose(t[k], j[k], **F64)
            elif isinstance(j[k], np.ndarray):
                np.testing.assert_array_equal(t[k], j[k])


def test_resume_skips_what_jax_archived(tmp_path):
    jw = jdg.Datagen(_cfg(jdg, tmp_path, batch_size=1)).run()
    assert len(jw) == 3
    # every run archived by JAX: the port's resume evolves nothing
    assert tdg.Datagen(_cfg(tdg, tmp_path, batch_size=1)).run() == []
    want = jio.load_run(jw[1])
    jw[1].unlink()
    again = tdg.Datagen(_cfg(tdg, tmp_path, batch_size=1)).run()
    assert [p.name for p in again] == [jw[1].name]
    got = tio.load_run(again[0])
    np.testing.assert_array_equal(got["u0"], want["u0"])
    np.testing.assert_allclose(got["u"], want["u"], **F64)


def test_cli_main_cpu(tmp_path, capsys):
    rc = tcli.main(["nlse", "--phenomenon", "multi_soliton", "--nx", "32",
                    "--T", "0.01", "--nt", "10", "--snapshots", "3",
                    "--num-runs", "2", "--krylov-m", "6", "--anisotropy-type",
                    "layered", "--m-type", "piecewise", "--record-energy",
                    "--format", "npy", "--device", "cpu", "--output-dir",
                    str(tmp_path)])
    assert rc == 0
    assert "wrote 2 archives" in capsys.readouterr().out
    runs = sorted((tmp_path / "npy").glob("run_*.json"))
    assert len(runs) == 2
    for p in runs:
        d = _npy_run(p)
        assert d["u"].shape == (3, N, N) and np.isfinite(d["u"]).all()
        assert d["mass"].shape == (3,)


def test_unported_arguments_raise(tmp_path):
    """The batch-axis arguments, ported since: a mesh without the batch
    axis raises JAX's ValueError in Datagen (with and without shard_grid)
    and in both engines; --shard-batch builds the mesh JAX's _build_mesh
    builds, on --device."""
    from nlsolvers_tpu_torch.parallel import mesh as tmesh
    grid_mesh = tmesh.make_mesh(("gy", "gx"), (2, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="batch axis"):
        tdg.Datagen(_cfg(tdg, tmp_path, mesh=grid_mesh))
    with pytest.raises(ValueError, match="batch axis"):
        teng.make_nlse_trajectory_fn("cubic", (N, N), LX, DT,
                                     mesh=grid_mesh, device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        teng.make_realwave_trajectory_fn("sine_gordon", (N, N), LX, DT,
                                         mesh=grid_mesh, device="cpu")
    wrong = tmesh.make_mesh(("batch", "gy"), (1, 2), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not an axis"):
        tdg.Datagen(_cfg(tdg, tmp_path, mesh=wrong, shard_grid=(2, 1)))
    parser = tcli.build_parser()
    base = ["nlse", "--phenomenon", "multi_soliton", "--device", "cpu",
            "--output-dir", str(tmp_path)]
    for flag, shape, axes in (
            (["--shard-batch", "2"], (2,), ("batch",)),
            (["--shard-batch", "2", "--shard-grid", "2,2"], (2, 2, 2),
             ("batch", "gy", "gx")),
            (["--shard-batch", "-1"], (1,), ("batch",))):
        cfg = tcli.config_from_args(parser.parse_args(base + flag))
        assert cfg.mesh.shape == shape and cfg.mesh.axis_names == axes
        assert all(d.type == "cpu" for d in cfg.mesh.devices)
    assert tcli.config_from_args(parser.parse_args(
        base + ["--shard-grid", "2,2"])).mesh is None


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: Datagen runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdg.Datagen(_cfg(tdg, tmp_path, device="cuda"))
