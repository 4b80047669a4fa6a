"""Fused Lanczos kernels of the port: plain versions vs the JAX Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_pallas.py runs them; the port's plain versions (`*_ref`, what a
wrapper runs for a CPU tensor) get the same seeded float32 inputs.

Tolerances (float32):
* fields: rel-L2 <= 1e-5. The elementwise arithmetic is the same sequence;
  only the last bits differ.
* reduced dots <a, b>: |got - want| <= 1e-5 * ||a|| ||b||, the Cauchy-Schwarz
  scale of a float32 dot, since the summation order differs and some dots
  (the gram terms of orthogonal columns) are near zero.
* Lanczos columns W_i: rel-L2 <= 1e-4. Each column is a residual about half
  the size of the terms it is rebuilt from, so float32 rounding doubles per
  iteration: 3e-5 at i = 7 here.

Both operators are covered: the 5-point Laplacian (iso2d: K1, K2) and the
finite-volume div(c grad u) with c = 1 + 0.4 U[0, 1) (aniso2d: K1', K2').
The CUDA kernels themselves are checked against these plain versions on the
card by chip_smoke.py and tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas import lanczos2d as jl
from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl

torch.set_num_threads(1)

N = 128
TILE = 32
FIELD_TOL = 1e-5
DOT_TOL = 1e-5
COL_TOL = 1e-4


def _desc(variant="reference", n=N):
    dx = 2 * 5.0 / (n - 1)
    return jops.laplacian_2d((n, n), dx, dx, variant=variant,
                             dtype=jnp.float32)._pallas_desc


def _fields(k, P, seed, n=N):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((P, n, n)).astype(np.float32)
            for _ in range(k)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check_dots(got, want, lefts, right):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i, a in enumerate(lefts):
        scale = np.linalg.norm(a) * np.linalg.norm(right)
        assert np.abs(got[i] - want[i]).max() <= DOT_TOL * scale, i


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("P,j,variant", [(2, 0, "reference"),
                                         (2, 2, "reference"),
                                         (2, 2, "clean"), (1, 2, "reference")])
def test_pass1_ref_matches_pallas(P, j, variant):
    desc = _desc(variant)
    W = _fields(j + 1, P, 10 + j)
    scal = np.array([[0.7, 0.3]], np.float32)
    wj, prev = W[j], W[:j]
    halo = jl._gather_halo_rows(jnp.asarray(wj), TILE, N)
    w_j, raw_j = jl._pass1_call(j, P, N, N, TILE, desc["scale"], desc["sign"],
                                variant, True)(
        jnp.asarray(scal), jnp.asarray(wj), halo, *map(jnp.asarray, prev))
    w_t, raw_t = tl.pass1_iso2d_ref(torch.from_numpy(scal),
                                    torch.from_numpy(wj), _t(prev), desc)
    assert _rel(w_t.numpy(), w_j) <= FIELD_TOL
    _check_dots(raw_t.numpy(), raw_j, prev + [wj], np.asarray(w_j))


def _pipe_inputs(j, P, seed):
    rng = np.random.default_rng(seed)
    av, *W = _fields(j + 2, P, seed)
    scal = rng.uniform(-0.5, 0.5, (j + 2, 2)).astype(np.float32)
    scal[0] = (0.8, 0.0)
    return scal, av, W


@pytest.mark.parametrize("P,j", [(2, j) for j in range(7)] + [(1, 0), (1, 6)])
def test_pipe_ref_matches_pallas(P, j):
    """Every iteration of an m=8 run, the last one (j = m-2) without the
    stencil; real fields (P=1) at the first and the last."""
    m = 8
    last = j == m - 2
    desc = _desc()
    scal, av, W = _pipe_inputs(j, P, 20 + j)
    args = [jnp.asarray(scal), jnp.asarray(av)]
    if not last:
        halos = jnp.stack([jl._gather_halo_rows(jnp.asarray(a), TILE, N)
                           for a in [av] + W])
        args.append(halos.reshape((j + 2) * P, N // TILE, 2, N))
    args.extend(map(jnp.asarray, W))
    res_j = jl._pipe_call(j, P, N, N, TILE, desc["scale"], desc["sign"],
                          desc["variant"], True, last=last)(*args)
    res_t = tl.pipe_iso2d_ref(torch.from_numpy(scal), torch.from_numpy(av),
                              _t(W), desc, last)
    assert len(res_t) == len(res_j)
    wn = np.asarray(res_j[0])
    assert _rel(res_t[0].numpy(), wn) <= FIELD_TOL
    if last:
        _, nsq_j, gram_j = res_j
        _, nsq_t, gram_t = res_t
    else:
        _, avn_j, nsq_j, gram_j, d_j = res_j
        _, avn_t, nsq_t, gram_t, d_t = res_t
        assert _rel(avn_t.numpy(), avn_j) <= FIELD_TOL
        _check_dots(d_t.numpy(), d_j, W + [wn], np.asarray(avn_j))
    assert abs(float(nsq_t[0, 0]) - float(nsq_j[0, 0])) <= (
        DOT_TOL * float(nsq_j[0, 0]))
    _check_dots(gram_t.numpy(), gram_j, W, wn)


@pytest.mark.parametrize("k,P", [(1, 2), (2, 2), (2, 1)])
def test_combine_ref_matches_pallas(k, P):
    m = 8
    W = _fields(m, P, 30 + k)
    q = np.random.default_rng(3).uniform(-1, 1, (k, m, 2)).astype(np.float32)
    outs_j = jl._combine_call(m, k, P, N, N, TILE, True)(
        jnp.asarray(q), *map(jnp.asarray, W))
    outs_t = tl.combine_ref(torch.from_numpy(q), _t(W))
    assert len(outs_t) == k
    for a, b in zip(outs_t, outs_j):
        assert _rel(a.numpy(), b) <= FIELD_TOL


@pytest.mark.parametrize("variant", ["reference", "clean"])
def test_lanczos_and_matfunc_planar_match_pallas(variant):
    """lanczos_planar (W, s, alpha, beta, beta0) and matfunc_apply_planar at
    128^2, m=8, against the JAX pipelined driver in interpret mode."""
    m = 8
    desc = _desc(variant)
    (u,) = _fields(1, 2, 40)
    t = 1j * 1e-3

    @jax.jit        # one compile for both calls: interpret mode is slow
    def pallas(uj):
        return (jl.lanczos_planar(uj, desc, m, interpret=True),
                jl.matfunc_apply_planar(uj, desc, np.complex64(t), "exp", m,
                                        interpret=True))

    (W_j, s_j, a_j, b_j, b0_j), y_j = pallas(jnp.asarray(u))
    W_t, s_t, a_t, b_t, b0_t = tl.lanczos_planar(torch.from_numpy(u), desc, m)
    assert len(W_t) == m
    for x, y in zip(W_t, W_j):
        assert _rel(x.numpy(), y) <= COL_TOL
    assert _rel(torch.stack(s_t).numpy(), jnp.stack(s_j)) <= FIELD_TOL
    assert _rel(torch.stack(a_t).numpy(), jnp.stack(a_j)) <= FIELD_TOL
    assert _rel(torch.stack(b_t).numpy(), jnp.stack(b_j)) <= FIELD_TOL
    assert abs(float(b0_t) - float(b0_j)) <= FIELD_TOL * float(b0_j)
    y_t = tl.matfunc_apply_planar(torch.from_numpy(u), desc, t, "exp", m)
    assert _rel(y_t.numpy(), y_j) <= FIELD_TOL


def test_zero_start_vector_stays_finite():
    """safe_inv keeps a zero start vector's columns at 0: f(L) 0 = 0."""
    desc = _desc(n=16)
    z = torch.zeros((2, 16, 16))
    W, s, a, b, b0 = tl.lanczos_planar(z, desc, 6)
    assert all(float(x) == 0.0 for x in s)
    y = tl.matfunc_apply_planar(z, desc, 1j * 1e-3, "exp", 6)
    assert torch.isfinite(y).all() and not y.abs().max() > 0


def test_cpu_tensors_never_launch_kernels():
    """Under kernel_mode "auto" a CPU tensor takes the plain versions; the
    launch counters count kernel launches only."""
    assert config.kernel_mode == "auto"
    before = (tl.pass1_iso2d.launches, tl.pipe_iso2d.launches,
              tl.combine.launches)
    (u,) = _fields(1, 2, 41, n=24)
    y = tl.matfunc_apply_planar(torch.from_numpy(u), _desc(n=24), 1j * 1e-3,
                                "exp", 6)
    assert torch.isfinite(y).all()
    assert (tl.pass1_iso2d.launches, tl.pipe_iso2d.launches,
            tl.combine.launches) == before


@pytest.mark.parametrize("case", ["m", "specs", "desc"])
def test_limits_raise(case):
    desc = _desc(n=16)
    u = torch.zeros((2, 16, 16))
    if case == "m":
        with pytest.raises(ValueError):
            tl.lanczos_planar(u, desc, tl.MAX_M + 1)
    elif case == "specs":
        with pytest.raises(ValueError):
            tl.combine(torch.zeros((tl.MAX_SPECS + 1, 2, 2)), [u, u])
    else:
        with pytest.raises(NotImplementedError):
            tl.lanczos_planar(u, dict(desc, kind="laplacian_3d"), 4)


# ------------------------------------------------------------ aniso2d (K1', K2')

def _descs_aniso(n=N, ny=None):
    """(JAX descriptor, port descriptor) of div(c grad u) on (ny, n), with
    c = 1 + 0.4 U[0, 1)."""
    ny = n if ny is None else ny
    c = (1.0 + 0.4 * np.random.default_rng(4).random((ny, n))).astype(
        np.float32)
    dx = 2 * 5.0 / (n - 1)
    return (jops.anisotropic_laplacian_2d(c, dx, dx)._pallas_desc,
            tops.anisotropic_laplacian_2d(c, dx, dx, device="cpu").kernel_desc)


def _aniso_ops(dj, tile):
    """JAX's aniso2d operator streams: wx, wy and the gathered wy halo row."""
    wx = jnp.asarray(dj["wx"]).reshape(1, N, N)
    wy = jnp.asarray(dj["wy"]).reshape(1, N, N)
    return wx, wy, jl._gather_halo_rows(wy, tile, N, per_block=1)


@pytest.mark.parametrize("P,j", [(2, 0), (2, 2), (1, 0), (1, 2)])
def test_pass1_aniso_ref_matches_pallas(P, j):
    dj, dt = _descs_aniso()
    W = _fields(j + 1, P, 50 + j)
    scal = np.array([[0.7, 0.3]], np.float32)
    wj, prev = W[j], W[:j]
    halo = jl._gather_halo_rows(jnp.asarray(wj), TILE, N)
    w_j, raw_j = jl._pass1_call(j, P, N, N, TILE, dj["scale"], dj["sign"],
                                "aniso", True, mode="aniso2d")(
        jnp.asarray(scal), jnp.asarray(wj), halo, *_aniso_ops(dj, TILE),
        *map(jnp.asarray, prev))
    w_t, raw_t = tl.pass1_aniso2d_ref(torch.from_numpy(scal),
                                      torch.from_numpy(wj), _t(prev), dt)
    assert _rel(w_t.numpy(), w_j) <= FIELD_TOL
    _check_dots(raw_t.numpy(), raw_j, prev + [wj], np.asarray(w_j))


@pytest.mark.parametrize("P,j", [(2, j) for j in range(7)] + [(1, 0), (1, 6)])
def test_pipe_aniso_ref_matches_pallas(P, j):
    """Every iteration of an m=8 run with the aniso stencil, the last one
    (j = m-2) without it and without the weight streams."""
    m = 8
    last = j == m - 2
    dj, dt = _descs_aniso()
    scal, av, W = _pipe_inputs(j, P, 60 + j)
    args = [jnp.asarray(scal), jnp.asarray(av)]
    if not last:
        halos = jnp.stack([jl._gather_halo_rows(jnp.asarray(a), TILE, N)
                           for a in [av] + W])
        args.append(halos.reshape((j + 2) * P, N // TILE, 2, N))
        args.extend(_aniso_ops(dj, TILE))
    args.extend(map(jnp.asarray, W))
    res_j = jl._pipe_call(j, P, N, N, TILE, dj["scale"], dj["sign"], "aniso",
                          True, mode="aniso2d", last=last)(*args)
    res_t = tl.pipe_aniso2d_ref(torch.from_numpy(scal), torch.from_numpy(av),
                                _t(W), dt, last)
    assert len(res_t) == len(res_j)
    wn = np.asarray(res_j[0])
    assert _rel(res_t[0].numpy(), wn) <= FIELD_TOL
    if not last:
        avn_j, d_j = res_j[1], res_j[4]
        assert _rel(res_t[1].numpy(), avn_j) <= FIELD_TOL
        _check_dots(res_t[4].numpy(), d_j, W + [wn], np.asarray(avn_j))
    nsq_j, gram_j = res_j[-2:] if last else res_j[2:4]
    nsq_t, gram_t = res_t[-2:] if last else res_t[2:4]
    assert abs(float(nsq_t[0, 0]) - float(nsq_j[0, 0])) <= (
        DOT_TOL * float(nsq_j[0, 0]))
    _check_dots(gram_t.numpy(), gram_j, W, wn)


def test_lanczos_and_matfunc_planar_aniso_match_pallas():
    """lanczos_planar and matfunc_apply_planar with an aniso descriptor at
    128^2, m=8, against the JAX pipelined driver in interpret mode; on the
    CPU no kernel is launched."""
    m = 8
    dj, dt = _descs_aniso()
    (u,) = _fields(1, 2, 70)
    t = 1j * 1e-3

    @jax.jit
    def pallas(uj):
        return (jl.lanczos_planar(uj, dj, m, interpret=True),
                jl.matfunc_apply_planar(uj, dj, np.complex64(t), "exp", m,
                                        interpret=True))

    (W_j, s_j, a_j, b_j, b0_j), y_j = pallas(jnp.asarray(u))
    counters = (tl.pass1_aniso2d, tl.pipe_aniso2d, tl.combine)
    before = [f.launches for f in counters]
    W_t, s_t, a_t, b_t, b0_t = tl.lanczos_planar(torch.from_numpy(u), dt, m)
    assert len(W_t) == m
    for x, y in zip(W_t, W_j):
        assert _rel(x.numpy(), y) <= COL_TOL
    assert _rel(torch.stack(s_t).numpy(), jnp.stack(s_j)) <= FIELD_TOL
    assert _rel(torch.stack(a_t).numpy(), jnp.stack(a_j)) <= FIELD_TOL
    assert _rel(torch.stack(b_t).numpy(), jnp.stack(b_j)) <= FIELD_TOL
    assert abs(float(b0_t) - float(b0_j)) <= FIELD_TOL * float(b0_j)
    y_t = tl.matfunc_apply_planar(torch.from_numpy(u), dt, t, "exp", m)
    assert _rel(y_t.numpy(), y_j) <= FIELD_TOL
    assert [f.launches for f in counters] == before


def test_supported_desc_aniso():
    """Any grid with sides >= 3 qualifies (no TPU alignment gates); the face
    weights must be float32 (ny, nx) tensors."""
    _, dt = _descs_aniso(n=7, ny=5)
    assert tl.supported_desc(dt, (5, 7), torch.complex64)
    assert tl.supported_desc(dt, (5, 7), torch.float32)
    assert not tl.supported_desc(dt, (5, 7), torch.complex128)
    assert not tl.supported_desc(dt, (7, 5), torch.complex64)
    assert not tl.supported_desc(dict(dt, wx=dt["wx"].double()), (5, 7),
                                 torch.complex64)
    assert not tl.supported_desc(dict(dt, wy=None), (5, 7), torch.complex64)
