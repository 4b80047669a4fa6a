"""The port's host modules of the datagen pipeline against the JAX package's.

nlsolvers_tpu_torch/pipeline/{grids, spaces, fields, downsample, io_hdf5}
and samplers/ are numpy copies of nlsolvers_tpu/pipeline/; the native npy
writer is a copy of nlsolvers_tpu/native/. With the same seed both draw the
same numbers, so every comparison here is EQUAL arrays (and equal
parameter dicts), not a tolerance:

* every c(x) and m(x) kind the CLI offers (C_TYPES, M_TYPES, the reference
  aliases included), 2D at 48^2 and 3D at 16^3;
* every phenomenon of each sampler and every system, at 32^2 / 16^3, and a
  draw from every curated parameter space (draw_from_space, then
  resolve_param_ranges);
* the parameter-space tables, gaussian_random_field, resolve_param_ranges;
* fft and interpolation downsampling and their reconstructions, 2D and 3D;
* an HDF5 run written by the port read by JAX's load_run and the reverse;
  without h5py the port's writer raises a RuntimeError that names the npy
  format;
* the port's native writer (built into nlsolvers_tpu_torch/_build/) round
  trip, every dtype it takes, sync and async, beside JAX's writer.
"""

import sys

import numpy as np
import pytest
import torch

from nlsolvers_tpu import native as jnative
from nlsolvers_tpu.pipeline import __main__ as jcli
from nlsolvers_tpu.pipeline import datagen as jdatagen
from nlsolvers_tpu.pipeline import downsample as jds
from nlsolvers_tpu.pipeline import fields as jfields
from nlsolvers_tpu.pipeline import grids as jgrids
from nlsolvers_tpu.pipeline import io_hdf5 as jio
from nlsolvers_tpu.pipeline import spaces as jspaces
from nlsolvers_tpu.pipeline.samplers import nlse2d as jn2
from nlsolvers_tpu.pipeline.samplers import nlse3d as jn3
from nlsolvers_tpu.pipeline.samplers import realwave2d as jr2
from nlsolvers_tpu.pipeline.samplers import realwave3d as jr3
from nlsolvers_tpu_torch import native as tnative
from nlsolvers_tpu_torch.pipeline import __main__ as tcli
from nlsolvers_tpu_torch.pipeline import datagen as tdatagen
from nlsolvers_tpu_torch.pipeline import downsample as tds
from nlsolvers_tpu_torch.pipeline import fields as tfields
from nlsolvers_tpu_torch.pipeline import grids as tgrids
from nlsolvers_tpu_torch.pipeline import io_hdf5 as tio
from nlsolvers_tpu_torch.pipeline import spaces as tspaces
from nlsolvers_tpu_torch.pipeline.samplers import nlse2d as tn2
from nlsolvers_tpu_torch.pipeline.samplers import nlse3d as tn3
from nlsolvers_tpu_torch.pipeline.samplers import realwave2d as tr2
from nlsolvers_tpu_torch.pipeline.samplers import realwave3d as tr3

torch.set_num_threads(1)

N, L, N3, L3 = 48, 5.0, 16, 3.0


def _equal(a, b):
    """Equal structure and values: arrays bit-equal (NaN where NaN), dicts
    and sequences entry by entry."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)) and not isinstance(b, np.ndarray):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b or (a != a and b != b), (a, b)


def _same(jfn, tfn):
    """jfn() and tfn() give equal results; returns the port's."""
    want = jfn()
    got = tfn()
    _equal(got, want)
    return got


def _grids(dim):
    if dim == 2:
        return jgrids.Grid2D(N, N, L), tgrids.Grid2D(N, N, L)
    return (jgrids.Grid3D(N3, N3, N3, L3), tgrids.Grid3D(N3, N3, N3, L3))


def test_cli_field_lists_match_jax():
    assert tcli.C_TYPES == jcli.C_TYPES and tcli.M_TYPES == jcli.M_TYPES
    assert tcli.NLSE_SYSTEMS == jcli.NLSE_SYSTEMS
    assert tcli.REALWAVE_SYSTEMS == jcli.REALWAVE_SYSTEMS
    assert sorted(tfields.C_FIELD_TYPES) == sorted(jfields.C_FIELD_TYPES)
    assert sorted(tfields.M_FIELD_TYPES) == sorted(jfields.M_FIELD_TYPES)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", jcli.C_TYPES)
def test_c_field_equal(kind, dim):
    jg, tg = _grids(dim)
    got = _same(lambda: jfields.sample_c_field(jg, np.random.default_rng(7),
                                               kind=kind),
                lambda: tfields.sample_c_field(tg, np.random.default_rng(7),
                                               kind=kind))
    assert got[0].shape == ((N,) * 2 if dim == 2 else (N3,) * 3)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", jcli.M_TYPES)
def test_m_field_equal(kind, dim):
    jg, tg = _grids(dim)

    def draw(fields, g):
        rng = np.random.default_rng(11)
        c = fields.c_field("periodic", g, rng)
        return fields.sample_m_field(g, rng, kind=kind, c=c, m0=1.3)

    _same(lambda: draw(jfields, jg), lambda: draw(tfields, tg))


@pytest.mark.parametrize("dim", [2, 3])
def test_random_kind_and_grf_equal(dim):
    jg, tg = _grids(dim)
    for seed in range(4):
        _same(lambda: jfields.sample_c_field(jg, np.random.default_rng(seed)),
              lambda: tfields.sample_c_field(tg,
                                             np.random.default_rng(seed)))
        _same(lambda: jfields.sample_m_field(jg, np.random.default_rng(seed)),
              lambda: tfields.sample_m_field(tg,
                                             np.random.default_rng(seed)))
    _same(lambda: jgrids.gaussian_random_field(
              jg, np.random.default_rng(3), length_scale=1.0, amplitude=2.5),
          lambda: tgrids.gaussian_random_field(
              tg, np.random.default_rng(3), length_scale=1.0, amplitude=2.5))


def test_spaces_and_param_ranges_equal():
    _equal(tspaces.nlse_parameter_spaces(), jspaces.nlse_parameter_spaces())
    _equal(tspaces.nlse_parameter_spaces_3d(),
           jspaces.nlse_parameter_spaces_3d())
    for Lx in (L, L3, 10.0):
        _equal(tspaces.realwave_parameter_spaces(Lx),
               jspaces.realwave_parameter_spaces(Lx))
        _equal(tspaces.realwave_parameter_spaces_3d(Lx),
               jspaces.realwave_parameter_spaces_3d(Lx))
    spec = {"a": [1, 2, 3], "b": (0.0, 1.0), "c": (1, 5),
            "d": [(0.0, 1.0), (2.0, 3.0)]}
    for seed in range(5):
        _same(lambda: jgrids.resolve_param_ranges(
                  np.random.default_rng(seed), spec, fixed={"e": "x"}),
              lambda: tgrids.resolve_param_ranges(
                  np.random.default_rng(seed), spec, fixed={"e": "x"}))
        space = jspaces.nlse_parameter_spaces()["multi_soliton"]
        _same(lambda: jdatagen.draw_from_space(np.random.default_rng(seed),
                                               space),
              lambda: tdatagen.draw_from_space(np.random.default_rng(seed),
                                               space))


@pytest.mark.parametrize("phen", sorted(jn2.PHENOMENA))
def test_nlse2d_phenomenon_equal(phen):
    for system in jn2.SYSTEM_TYPES:
        _same(lambda: jn2.NLSEPhenomenonSampler(32, 32, L, seed=3)
              .generate_sample(phen, system_type=system),
              lambda: tn2.NLSEPhenomenonSampler(32, 32, L, seed=3)
              .generate_sample(phen, system_type=system))


@pytest.mark.parametrize("phen", sorted(jn3.PHENOMENA))
def test_nlse3d_phenomenon_equal(phen):
    for system in jn2.SYSTEM_TYPES[:3]:
        _same(lambda: jn3.NLSE3DSampler(N3, N3, N3, L3, seed=4)
              .generate_sample(phen, system_type=system),
              lambda: tn3.NLSE3DSampler(N3, N3, N3, L3, seed=4)
              .generate_sample(phen, system_type=system))


@pytest.mark.parametrize("phen", sorted(jr2.PHENOMENA))
def test_realwave2d_phenomenon_equal(phen):
    for system in jr2.SYSTEM_TYPES:
        _same(lambda: jr2.RealWaveSampler(32, 32, L, seed=5).generate_sample(
                  system_type=system, phenomenon_type=phen),
              lambda: tr2.RealWaveSampler(32, 32, L, seed=5).generate_sample(
                  system_type=system, phenomenon_type=phen))


@pytest.mark.parametrize("phen", sorted(jr3.PHENOMENA))
def test_realwave3d_phenomenon_equal(phen):
    for system in jr2.SYSTEM_TYPES:
        _same(lambda: jr3.RealWaveSampler3d(N3, N3, N3, L3, seed=6)
              .generate_sample(system_type=system, phenomenon_type=phen),
              lambda: tr3.RealWaveSampler3d(N3, N3, N3, L3, seed=6)
              .generate_sample(system_type=system, phenomenon_type=phen))


def _space_draws(family, dim, Lx):
    """(sampler pair, phenomenon, system, params) per curated space entry,
    drawn as Datagen draws them (draw_from_space, then the sampler)."""
    if family == "nlse":
        table = (jspaces.nlse_parameter_spaces() if dim == 2
                 else jspaces.nlse_parameter_spaces_3d())
    else:
        table = (jspaces.realwave_parameter_spaces(Lx) if dim == 2
                 else jspaces.realwave_parameter_spaces_3d(Lx))
    rng = np.random.default_rng(21)
    for phen, space in table.items():
        params = dict(jdatagen.draw_from_space(rng, space))
        yield phen, params.pop("system_type", None), params


@pytest.mark.parametrize("family,dim", [("nlse", 2), ("nlse", 3),
                                        ("realwave", 2), ("realwave", 3)])
def test_space_draws_equal(family, dim):
    n, Lx = (32, L) if dim == 2 else (12, L3)
    for phen, system, params in _space_draws(family, dim, Lx):
        if family == "nlse" and dim == 2:
            mk = lambda m: m.NLSEPhenomenonSampler(n, n, Lx, seed=8)
            mods = (jn2, tn2)
            call = lambda s: s.generate_sample(
                phen, system_type=system or "cubic", **params)
        elif family == "nlse":
            mk = lambda m: m.NLSE3DSampler(n, n, n, Lx, seed=8)
            mods = (jn3, tn3)
            call = lambda s: s.generate_sample(
                phen, system_type=system or "cubic", **params)
        elif dim == 2:
            mk = lambda m: m.RealWaveSampler(n, n, Lx, seed=8)
            mods = (jr2, tr2)
            call = lambda s: s.generate_sample(
                system_type=system or "sine_gordon", phenomenon_type=phen,
                **params)
        else:
            mk = lambda m: m.RealWaveSampler3d(n, n, n, Lx, seed=8)
            mods = (jr3, tr3)
            call = lambda s: s.generate_sample(
                system_type=system or "klein_gordon", phenomenon_type=phen,
                **params)
        _same(lambda: call(mk(mods[0])), lambda: call(mk(mods[1])))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("method", ["fft", "interpolation"])
def test_downsample_equal(method, dim):
    rng = np.random.default_rng(9)
    shape, target, Lx = (((3, 32, 32), (16, 16), L) if dim == 2
                         else ((2, 16, 16, 16), (8, 8, 8), L3))
    u = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for x in (u, u.real.copy()):
        d = _same(lambda: jds.downsample_trajectory(x, target, *(Lx,) * dim,
                                                    method=method),
                  lambda: tds.downsample_trajectory(x, target, *(Lx,) * dim,
                                                    method=method))
        if method == "fft":
            _same(lambda: jds.reconstruct_fft(d, shape[1:]),
                  lambda: tds.reconstruct_fft(d, shape[1:]))
        else:
            _same(lambda: jds.reconstruct_interpolation(d.real, shape[1:],
                                                        Lx),
                  lambda: tds.reconstruct_interpolation(d.real, shape[1:],
                                                        Lx))


def _run_kwargs(seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((3, 16, 16)) + 1j * rng.standard_normal(
        (3, 16, 16))
    return dict(problem_type="cubic", run_id="ab12cd34", run_index=3,
                phenomenon="multi_soliton",
                phenomenon_params={"coherence": 0.5}, shape=(16, 16),
                extents=(L, L), T=1.0, nt=100, num_snapshots=3, u0=u[0],
                u=u, m=rng.random((16, 16)), c=rng.random((16, 16)),
                m_type="piecewise", m_attrs={"m_type": "piecewise"},
                elapsed_time=1.25, extra_meta={"krylov_m": 20},
                scalar_series={"mass": rng.random(3)})


def _loaded_equal(a, b, kw):
    """Two load_run dicts of one archive agree, the timestamp aside, and
    hold what was written."""
    ma, mb = dict(a.pop("metadata")), dict(b.pop("metadata"))
    assert ma.pop("timestamp") == mb.pop("timestamp")
    _equal(ma, mb)
    _equal(a, b)
    np.testing.assert_array_equal(a["u"], kw["u"])
    np.testing.assert_array_equal(a["focusing/m"], kw["m"])
    assert ma["problem_type"] == "cubic" and ma["phenomenon_coherence"] == \
        "0.5"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_written_by_one_read_by_both(tmp_path, writer):
    kw = _run_kwargs(1)
    save = tio.save_run if writer == "port" else jio.save_run
    path = save(tmp_path / "run.h5", **kw)
    _loaded_equal(tio.load_run(path), jio.load_run(path), kw)
    import h5py
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["energy/mass"][()],
                                      kw["scalar_series"]["mass"])


def test_hdf5_without_h5py_names_npy(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="npy"):
        tio.save_run(tmp_path / "run.h5", **_run_kwargs(2))
    with pytest.raises(RuntimeError, match="npy"):
        tio.load_run(tmp_path / "run.h5")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128, np.int32, np.int64,
                                   np.uint8, np.bool_])
def test_native_writer_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 5, 7)) * 100).astype(dtype)
    if np.iscomplexobj(a):
        a = a + 1j * rng.standard_normal(a.shape).astype(a.real.dtype)
    so = tnative._compile()
    assert so.parent.name == "_build" and so.parent.parent.name == \
        "nlsolvers_tpu_torch"
    with tnative.AsyncNpyWriter(n_threads=2) as w:
        for k in range(4):
            w.submit(tmp_path / f"a{k}.npy", a[k % 3])
        w.flush()
        assert w.errors == 0 and w.pending == 0
    tnative.write_npy_sync(tmp_path / "s.npy", a)
    jnative.write_npy_sync(tmp_path / "j.npy", a)
    for k in range(4):
        np.testing.assert_array_equal(np.load(tmp_path / f"a{k}.npy"),
                                      a[k % 3])
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), a)
    assert (tmp_path / "s.npy").read_bytes() == \
        (tmp_path / "j.npy").read_bytes()
