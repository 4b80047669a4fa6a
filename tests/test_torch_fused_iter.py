"""The fused Lanczos iteration of the port (config.fused_iter: one K5
`iter_step` per iteration, ops/cuda/lanczos2d.py) against the JAX package's
(lanczos2d._FUSED_ITER: `_iter_call`, in Pallas interpret mode, as
tests/test_pallas.py runs it).

Inputs are made with numpy from a seed and given to both sides.
Tolerances (float32, the same algorithm on both sides):
* Lanczos columns W_i: rel-L2 <= 1e-4. Each column is a residual about
  half the size of the terms it is rebuilt from, so float32 rounding
  doubles per iteration (tests/test_torch_lanczos2d.py's gate).
* s_i, alpha, beta, beta0 and the matrix-function output: rel-L2 <= 1e-5.
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
from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3

torch.set_num_threads(1)

FIELD_TOL = 1e-5
COL_TOL = 1e-4
M = 8


@pytest.fixture
def fused_on(monkeypatch):
    """The fused iteration switched on in both packages."""
    monkeypatch.setattr(jl, "_FUSED_ITER", True)
    monkeypatch.setattr(config, "fused_iter", True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _descs(mode):
    """(JAX descriptor, port descriptor, grid) of one K5 operator."""
    rng = np.random.default_rng(4)
    if mode == "aniso2d":
        shape = (16, 128)
        c = (1.0 + 0.4 * rng.random(shape)).astype(np.float32)
        dx = 2 * 5.0 / (shape[1] - 1)
        return (jops.anisotropic_laplacian_2d(c, dx, dx)._pallas_desc,
                tops.anisotropic_laplacian_2d(c, dx, dx,
                                              device="cpu").kernel_desc,
                shape)
    if mode == "aniso3d":
        shape = (16, 16, 128)
        c = (1.0 + 0.4 * rng.random(shape)).astype(np.float32)
        dx = 2 * 5.0 / (shape[2] - 1)
        return (jops.anisotropic_laplacian_3d(c, dx)._pallas_desc,
                tops.anisotropic_laplacian_3d(c, dx,
                                              device="cpu").kernel_desc,
                shape)
    if mode.endswith("3d"):
        shape, variant = (16, 16, 128), mode[:-2]
        dx = 2 * 5.0 / (shape[2] - 1)
        return (jops.laplacian_3d(shape, dx, variant=variant,
                                  dtype=jnp.float32)._pallas_desc,
                tops.laplacian_3d(shape, dx, variant=variant,
                                  device="cpu").kernel_desc, shape)
    shape = (16, 128)
    dx = 2 * 5.0 / (shape[1] - 1)
    return (jops.laplacian_2d(shape, dx, dx, variant=mode,
                              dtype=jnp.float32)._pallas_desc,
            tops.laplacian_2d(shape, dx, dx, variant=mode,
                              device="cpu").kernel_desc, shape)


def _field(shape, P, seed):
    rows = int(np.prod(shape[:-1]))
    return np.random.default_rng(seed).standard_normal(
        (P, rows, shape[-1])).astype(np.float32)


@pytest.mark.parametrize("mode,P", [("reference", 2), ("clean", 2),
                                    ("aniso2d", 2), ("reference", 1),
                                    ("reference3d", 2), ("clean3d", 2)])
def test_fused_loop_matches_pallas(mode, P, fused_on):
    """Every column W_j, every s_j and the T entries of an m=8 run (and,
    but for the clean variants, the matrix function) against JAX's fused
    loop; the CPU launches nothing."""
    jdesc, tdesc, shape = _descs(mode)
    u = _field(shape, P, 30 + P)
    t = np.complex64(1j * 1e-3) if P == 2 else np.float32(1e-3)
    func = "exp" if P == 2 else "cos_sqrt"

    with_y = not mode.startswith("clean")    # interpret mode is slow

    @jax.jit
    def pallas(uj):
        return (jl.lanczos_planar(uj, jdesc, M, interpret=True),
                jl.matfunc_apply_planar(uj, jdesc, t, func, M,
                                        interpret=True) if with_y else None)

    (W_j, s_j, a_j, b_j, b0_j), y_j = pallas(jnp.asarray(u))
    before = (tl.iter_step.launches, tl.pipe_iso2d.launches,
              t3.pass2.launches)
    W_t, s_t, a_t, b_t, b0_t = tl.lanczos_planar(torch.from_numpy(u), tdesc,
                                                 M)
    assert len(W_t) == M
    for x, y in zip(W_t, W_j):
        assert _rel(x.numpy(), y) <= COL_TOL
    assert _rel(torch.stack(s_t).numpy(), jnp.stack(s_j)) <= FIELD_TOL
    assert _rel(torch.stack(a_t).numpy(), jnp.stack(a_j)) <= FIELD_TOL
    assert _rel(torch.stack(b_t).numpy(), jnp.stack(b_j)) <= FIELD_TOL
    assert abs(float(b0_t) - float(b0_j)) <= FIELD_TOL * float(b0_j)
    if with_y:
        y_t = tl.matfunc_apply_planar(torch.from_numpy(u), tdesc, t, func, M)
        assert _rel(y_t.numpy(), y_j) <= FIELD_TOL
    assert (tl.iter_step.launches, tl.pipe_iso2d.launches,
            t3.pass2.launches) == before


def test_iter_ref_is_the_two_passes():
    """iter_ref is pass1 then pass2 with q_i = s_i^2 raw_i."""
    _, tdesc, shape = _descs("aniso2d")
    W = [torch.from_numpy(_field(shape, 2, 40 + i)) for i in range(4)]
    s = torch.tensor([0.9, 0.5, 0.7, 0.3])
    scal = torch.cat([torch.stack([s[3], torch.tensor(0.2)]), s])[None]
    wn, raw, nsq = tl.iter_ref(scal, W[3], W[:3], tdesc)
    w, raw1 = tl.pass1_aniso2d_ref(scal[:, :2], W[3], W[:3], tdesc)
    wn2, nsq2 = t3.pass2_ref((s * s)[:, None] * raw1, w, W)
    assert torch.equal(raw, raw1) and torch.equal(wn, wn2)
    assert torch.equal(nsq, nsq2)


def test_aniso3d_is_refused_as_jax_refuses(fused_on):
    """JAX's _iter_call has no aniso3d mode (a KeyError); the port raises a
    ValueError where the 32 MiB rule would send aniso3d to K5."""
    jdesc, tdesc, shape = _descs("aniso3d")
    u = _field(shape, 2, 50)
    with pytest.raises(KeyError):
        jl.lanczos_planar(jnp.asarray(u), jdesc, 4, interpret=True)
    with pytest.raises(ValueError):
        tl.lanczos_planar(torch.from_numpy(u), tdesc, 4)
    with pytest.raises(ValueError):
        tl.iter_step(torch.ones((1, 3)), torch.from_numpy(u), [], tdesc)


def test_size_rule(fused_on, monkeypatch):
    """A field above FUSED_ITER_BYTES keeps the pipe (2D) and the two-pass
    loop (3D), as JAX's P * rows * nx * 4 <= 32 MiB rule does; the same
    field under the limit takes K5."""
    calls = []
    real = tl.iter_step
    monkeypatch.setattr(tl, "iter_step", lambda *a: calls.append(1) or real(
        *a))
    monkeypatch.setattr(t3, "iter_step", tl.iter_step)
    for mode in ("reference", "reference3d"):
        _, tdesc, shape = _descs(mode)
        u = torch.from_numpy(_field(shape, 2, 60))
        limit = u.numel() * 4
        monkeypatch.setattr(tl, "FUSED_ITER_BYTES", limit - 4)
        calls.clear()
        big = tl.lanczos_planar(u, tdesc, 4)
        assert not calls
        monkeypatch.setattr(tl, "FUSED_ITER_BYTES", limit)
        small = tl.lanczos_planar(u, tdesc, 4)
        assert len(calls) == 3
        for a, b in zip(big[0], small[0]):
            assert _rel(a.numpy(), b.numpy()) <= COL_TOL


# K5's form of w by size (tl.iter_plan): a shared-memory budget of the
# card's shape (per SM, per block, the static part of a block, the
# reserve per block) stands in for the occupancy query of the library
H100_SMEM = dict(sm=233472, block=232448, static=30 * 1024, reserved=1024,
                 sms=132)
SMALL_SMEM = dict(H100_SMEM, sm=96 * 1024, block=64 * 1024)


def _budget_fit(b):
    """Blocks per SM (at most the two of the kernel's launch bounds) that
    fit with dyn bytes of dynamic shared memory, under budget b."""
    def fit(dyn):
        need = b["static"] + dyn
        if need > b["block"]:
            return 0
        return min(tl.COOP_PER_SM, b["sm"] // (need + b["reserved"]))
    return fit


# (P, rows, nx, budget, onchip, grid): 1024^2 and 128^3 (the merged view)
# keep w on chip, two blocks per SM; 2048^2 (FUSED_ITER_BYTES admits it)
# and 1024^2 under a small budget take the global form; a field that fits
# only at one block per SM; fewer strip rows than SMs
_PLAN_CASES = [(2, 1024, 1024, H100_SMEM, True, 264),
               (2, 128 * 128, 128, H100_SMEM, True, 264),
               (1, 1024, 1024, H100_SMEM, True, 264),
               (2, 2048, 2048, H100_SMEM, False, 264),
               (2, 1024, 1024, SMALL_SMEM, False, 264),
               (2, 1792, 1792, H100_SMEM, True, 132),
               (2, 37, 131, H100_SMEM, True, 74),
               (2, 250, 333, SMALL_SMEM, True, 264)]


@pytest.mark.parametrize("P,rows,nx,budget,onchip,grid", _PLAN_CASES,
                         ids=[f"P{c[0]}-{c[1]}x{c[2]}-"
                              f"{'h100' if c[3] is H100_SMEM else 'small'}"
                              for c in _PLAN_CASES])
def test_iter_plan_keeps_w_on_chip_where_it_fits(P, rows, nx, budget,
                                                 onchip, grid):
    """The on-chip form where the largest grid of 2, then 1, blocks per SM
    holds every block's ceil(S / grid) w rows beside its static shared
    memory; the global form on the blocks that fit otherwise; never more
    blocks than rows of 128-column strips."""
    fit = _budget_fit(budget)
    got = tl.iter_plan(P, rows, nx, budget["sms"], fit)
    assert got == (onchip, grid)
    segs = -(-nx // 128) * rows
    wrows = -(-segs // grid)
    if onchip:
        assert fit(wrows * P * 128 * 4) * budget["sms"] >= grid
    else:
        for per_sm in (2, 1):
            g = min(per_sm * budget["sms"], segs)
            assert fit(-(-segs // g) * P * 128 * 4) * budget["sms"] < g
        assert fit(8 * P * 128 * 4) * budget["sms"] >= grid


def test_iter_form_reads_the_card_once_per_shape(monkeypatch):
    """iter_form asks the library for the SMs and the blocks that fit of the
    call's instantiation (bucket of j, 16-byte form) once per shape, and
    gives iter_plan's answer under a monkeypatched budget."""
    calls = []
    fit = _budget_fit(SMALL_SMEM)

    class FakeLib:
        def lz_num_sms(self):
            return SMALL_SMEM["sms"]

        def lz_iter_fit(self, P, opk, j, vec, dyn):
            calls.append((P, opk, j, vec, dyn))
            return fit(dyn)

    monkeypatch.setattr(tl, "_lib", lambda: FakeLib())
    monkeypatch.setattr(tl, "_plan_cache", {})
    assert tl.iter_form(2, 1024, 1024, 0, 5, True) == (False, 264)
    n = len(calls)
    assert n and all(c[:4] == (2, 0, 5, 1) for c in calls)
    assert tl.iter_form(2, 1024, 1024, 0, 7, True) == (False, 264)
    assert len(calls) == n                       # the same bucket and shape
    assert tl.iter_form(2, 250, 333, 1, 5, False) == (True, 264)
    assert calls[-1][:4] == (2, 1, 5, 0)
