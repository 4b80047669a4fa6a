"""The fused half kick with the no-flux ghost copy folded in
(ops/cuda/kick.py), against the JAX package's kick followed by its ghost
copy, and the SS2 steps that now close with it.

On the CPU the wrapper runs its plain version, kick_bc_ref; the kernel
(csrc/kick.cu) is held against it on the card (tests/test_torch_cuda_kernels
.py, chip_smoke.py). Inputs are made with numpy from a seed and handed to
both packages.

Tolerances:
* the kick and ghost copy vs JAX's phase_kick_planar followed by
  neumann_no_velocity_2d / _3d or the Pallas bc3d (interpret mode), float32:
  rel-L2 <= 1e-6 (the same elementwise arithmetic; sin and cos are each
  library's own);
* the kernel's index rule (every output cell takes the kicked input cell at
  the clamped index) against kick_bc_ref: exactly equal, on whole grids and
  on every block of split grids, with odd sides and blocks of 2 cells;
* the SS2 steps (ss2_step_planar with a grid, the 2D and 3D problems' SS2
  step and the sEWI bootstrap) vs JAX's step and its ghost copy with the
  Pallas kernels in interpret mode: rel-L2 <= 1e-5, the gate of
  tests/test_torch_problems*.py;
* the sharded step vs JAX's, with and without the ghost copy: rtol 3e-4,
  atol 3e-5, the gate of tests/test_torch_sharded*.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from nlsolvers_tpu import config as jconfig
from nlsolvers_tpu.models import nlse as jnlse
from nlsolvers_tpu.models import nonlinearities as jnl
from nlsolvers_tpu.models import problems as jproblems
from nlsolvers_tpu.ops import boundaries as jbc
from nlsolvers_tpu.ops import operators as jops
from nlsolvers_tpu.ops.pallas.bc3d import neumann_bc_planar_3d as jbc3d
from nlsolvers_tpu.parallel import spatial as jspatial
from nlsolvers_tpu_torch.models import nlse as tnlse
from nlsolvers_tpu_torch.models import nonlinearities as tnl
from nlsolvers_tpu_torch.models import problems as tproblems
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import kick as tk
from nlsolvers_tpu_torch.parallel import mesh as tmesh
from nlsolvers_tpu_torch.parallel import shards
from nlsolvers_tpu_torch.parallel import spatial as tspatial

torch.set_num_threads(1)

KINDS = ("cubic", "cubic_quintic", "saturable")
PARAMS = dict(sigma1=0.8, sigma2=-0.15, kappa=0.7)
LX, DT, M_KRY = 5.0, 1e-3, 6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(shape, seed):
    """A planar (2, R, nx) state and an (R, nx) m field, float32."""
    rng = np.random.default_rng(seed)
    R, nx = int(np.prod(shape[:-1])), shape[-1]
    up = rng.standard_normal((2, R, nx)).astype(np.float32)
    m = (0.5 + rng.random((R, nx))).astype(np.float32)
    return up, m


def _densities(kind, m):
    return (tnl.nlse_density_planar(kind, torch.from_numpy(m), **PARAMS),
            jnl.nlse_density_planar(kind, jnp.asarray(m), **PARAMS))


# ------------------------------------------------------------ (a) the kick

_GHOSTS = ["2d-none", "2d-ghost", "3d-none", "3d-ghost", "3d-ghost-pallas"]


@pytest.mark.parametrize("ghost", _GHOSTS)
@pytest.mark.parametrize("kind", KINDS)
def test_kick_bc_matches_jax_kick_and_ghost_copy(kind, ghost):
    """phase_kick_bc_planar on the CPU against JAX's phase_kick_planar, then
    (with a grid) its ghost copy: neumann_no_velocity_2d, _3d, or the Pallas
    bc3d kernel in interpret mode."""
    shape = (40, 64) if ghost.startswith("2d") else (8, 12, 16)
    up, m = _inputs(shape, 3 + len(ghost))
    trho, jrho = _densities(kind, m)
    theta = 0.3
    grid = None if ghost.endswith("none") else tk.kick_grid(shape)
    got = tk.phase_kick_bc_planar(torch.from_numpy(up), trho, theta, grid)
    ju = jnp.asarray(up)
    want = jnlse.phase_kick_planar(ju, jrho(ju), theta)
    if ghost == "2d-ghost":
        want = jbc.neumann_no_velocity_2d(want)
    elif ghost == "3d-ghost":
        want = jbc.neumann_no_velocity_3d(
            want.reshape((2,) + shape)).reshape(up.shape)
    elif ghost == "3d-ghost-pallas":
        want = jbc3d(want, shape, interpret=True)
    assert got.shape == up.shape
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-6
    assert tk.phase_kick_bc_planar.launches == 0     # CPU: the plain version


def test_kick_bc_is_out_of_place():
    shape = (6, 7, 9)
    up, m = _inputs(shape, 5)
    trho, _ = _densities("cubic", m)
    u = torch.from_numpy(up.copy())
    out = tk.phase_kick_bc_planar(u, trho, 0.2, tk.kick_grid(shape))
    assert out.data_ptr() != u.data_ptr()
    assert np.array_equal(u.numpy(), up)


# ------------------------------------------------------------ (b) the rule

def _clamped(kicked, shape, glob, offs):
    """The kernel's index rule, written out: every cell of the block takes
    the kicked cell at its clamped index (0 -> 1 on a block at the grid's
    low face of that axis, n-1 -> n-2 at the high face)."""
    idx = []
    for n, g, o in zip(shape, glob, offs):
        c = np.arange(n)
        if o == 0:
            c[0] = 1
        if o + n == g:
            c[n - 1] = n - 2
        idx.append(torch.from_numpy(c))
    grids = torch.meshgrid(*idx, indexing="ij")
    return kicked.reshape((2,) + shape)[(slice(None),) + grids].reshape(
        kicked.shape)


# (global shape, split): whole grids, odd sides, blocks of 2 cells per axis,
# blocks with no face on an axis
_SPLITS = [((3, 3), (1, 1)), ((7, 9), (1, 1)), ((4, 4), (2, 2)),
           ((6, 10), (2, 2)), ((10, 14), (2, 2)), ((5, 12), (1, 3)),
           ((3, 3, 3), (1, 1, 1)), ((5, 6, 7), (1, 1, 1)),
           ((4, 4, 4), (2, 2, 2)), ((6, 8, 10), (2, 2, 2)),
           ((4, 6, 14), (2, 2, 2)), ((4, 5, 9), (1, 1, 3))]


@pytest.mark.parametrize("glob,split", _SPLITS,
                         ids=[f"{'x'.join(map(str, g))}-on-"
                              f"{'x'.join(map(str, s))}" for g, s in _SPLITS])
def test_clamp_gather_equals_kick_bc_ref(glob, split):
    """On every block (with its offsets) the clamp gather of the kicked
    block equals kick_bc_ref bit for bit: the reference's ordered ghost copy
    is the index rule the kernel relies on, corners and odd sides included."""
    rng = np.random.default_rng(len(glob) * 100 + glob[-1])
    u = rng.standard_normal((2,) + glob).astype(np.float32)
    mg = (0.5 + rng.random(glob)).astype(np.float32)
    shape = tuple(g // s for g, s in zip(glob, split))
    R, nx = int(np.prod(shape[:-1])), shape[-1]
    whole = all(s == 1 for s in split)
    for pos in np.ndindex(*split):
        offs = tuple(p * n for p, n in zip(pos, shape))
        blk = tuple(slice(o, o + n) for o, n in zip(offs, shape))
        up = torch.from_numpy(
            np.ascontiguousarray(u[(slice(None),) + blk]).reshape(2, R, nx))
        rho = tnl.nlse_density_planar(
            "cubic", torch.from_numpy(np.ascontiguousarray(mg[blk]).reshape(
                R, nx)))
        grid = (tk.kick_grid(shape) if whole
                else tk.kick_grid(shape, glob, offs))
        got = tk.kick_bc_ref(up, rho, 0.4, grid)
        want = _clamped(tk.phase_kick_planar(up, rho(up), 0.4), shape, glob,
                        offs)
        assert torch.equal(got, want), pos


def test_kick_grid_faces_and_checks():
    assert tk.kick_grid((5, 6)).faces == (0, 0, 1, 1, 1, 1)
    assert tk.kick_grid((2, 3, 4), (4, 6, 8), (2, 0, 4)).faces == (
        0, 1, 1, 0, 0, 1)
    assert tk.kick_grid((2, 3), (6, 9), (2, 3)).faces == (0, 0, 0, 0, 0, 0)
    for bad in (((1, 5),), ((2, 2),), ((3, 3), (3, 4), (0, 2)),
                ((3, 3), (6, 6)), ((3, 3), (6, 6), (0, 0, 0)),
                ((4,),)):
        with pytest.raises(ValueError):
            tk.kick_grid(*bad)


# ------------------------------------------------------------ (c) the steps

def _jax_interpret(fn):
    old = jconfig.pallas_mode
    jconfig.pallas_mode = "interpret"
    try:
        return fn()
    finally:
        jconfig.pallas_mode = old


@pytest.mark.parametrize("kind,shape,bc", [
    ("cubic_quintic", (16, 128), True), ("cubic", (16, 128), False),
    ("saturable", (4, 8, 128), True)],
    ids=["2d-cubic_quintic", "2d-cubic-no-ghost", "3d-saturable"])
def test_ss2_step_planar_with_grid_matches_jax(kind, shape, bc):
    """ss2_step_planar(..., grid) against JAX's ss2_step_planar (Pallas in
    interpret mode) followed by its ghost copy; without a grid, against the
    step alone."""
    up, m = _inputs(shape, 11)
    up = 0.5 * up
    dx = 2.0 * LX / (shape[-1] - 1)
    if len(shape) == 2:
        tlap = tops.laplacian_2d(shape, dx, dx, dtype=torch.float32,
                                 device="cpu")
        jlap = jops.laplacian_2d(shape, dx, dx, dtype=jnp.float32)
        jneum = jbc.neumann_no_velocity_2d
    else:
        tlap = tops.laplacian_3d(shape, dx, dtype=torch.float32,
                                 device="cpu")
        jlap = jops.laplacian_3d(shape, dx, dtype=jnp.float32)
        jneum = jbc.neumann_no_velocity_3d
    trho, jrho = _densities(kind, m)
    got = tnlse.ss2_step_planar(torch.from_numpy(up), tlap.kernel_desc, trho,
                                DT, m=M_KRY,
                                grid=tk.kick_grid(shape) if bc else None)
    want = jnlse.ss2_step_planar(jnp.asarray(up), jlap._pallas_desc, jrho,
                                 DT, m=M_KRY, interpret=True)
    if bc:
        want = jneum(want.reshape((2,) + shape)).reshape(up.shape)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def _gaussian(shape):
    axes = [np.linspace(-LX, LX, n, dtype=np.float32) for n in shape]
    g = np.meshgrid(*axes, indexing="ij")
    env = np.exp(-sum(a * a for a in g) / 4)
    return (env * np.exp(0.4j * g[-1])).astype(np.complex64)


@pytest.mark.parametrize("kind,shape,integrator", [
    ("cubic_quintic", (16, 128), "ss2"), ("saturable", (4, 8, 128), "ss2"),
    ("cubic", (16, 128), "sewi"), ("cubic", (4, 8, 128), "sewi")],
    ids=["2d-ss2", "3d-ss2", "2d-sewi-bootstrap", "3d-sewi-bootstrap"])
def test_problem_step_matches_jax(kind, shape, integrator):
    """One step of the planar problem (the SS2 step, or the sEWI bootstrap
    at step index 1, both closing with the fused kick) against JAX's
    problem with the Pallas kernels in interpret mode. The bootstrap keeps
    its input, untouched, as u_prev."""
    rng = np.random.default_rng(17)
    mf = (0.5 + rng.random(shape)).astype(np.float32)
    kw = dict(m_field=mf, krylov_m=M_KRY, integrator=integrator, **PARAMS)
    u0 = _gaussian(shape)
    tprob = tproblems.nlse_problem(kind, shape, LX, DT, device="cpu", **kw)
    assert tprob.meta["planar_state"]
    s0 = tprob.init(u0)
    first = (s0[0] if integrator != "ss2" else s0).clone()
    s1 = tprob.step(s0, 1)

    def run():
        jprob = jproblems.nlse_problem(kind, shape, LX, DT,
                                       dtype=jnp.complex64, **kw)
        assert jprob.meta["planar_state"]
        return np.asarray(jprob.observe(jax.jit(jprob.step)(
            jprob.init(u0), 1)))

    want = _jax_interpret(run)
    assert _rel(tprob.observe(s1).numpy(), want) <= 1e-5
    if integrator != "ss2":
        assert s1[1] is s0[0]
        assert torch.equal(s1[1], first)
        assert torch.equal(s0[0], first)
    else:
        assert torch.equal(s0, first)


# ------------------------------------------------------------ (d) sharded

@pytest.mark.parametrize("dims,apply_bc", [(2, True), (2, False),
                                           (3, True), (3, False)],
                         ids=["2d-bc", "2d-no-bc", "3d-bc", "3d-no-bc"])
def test_sharded_step_matches_jax(dims, apply_bc):
    """make_sharded_nlse_step (every shard's closing kick with its block's
    ghost copy, or none with apply_bc=False) against JAX's step in interpret
    mode, on (2, 2) and (2, 2, 2) meshes, with the non-cubic densities and a
    non-uniform m."""
    if dims == 2:
        shape, mshape, axes, kind = (16, 256), (2, 2), ("gy", "gx"), \
            "cubic_quintic"
    else:
        shape, mshape, axes, kind = (8, 16, 256), (2, 2, 2), \
            ("gz", "gy", "gx"), "saturable"
    n = int(np.prod(mshape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    rng = np.random.default_rng(23 + dims)
    u0 = 0.1 * rng.standard_normal((2,) + shape).astype(np.float32)
    mf = (0.5 + rng.random(shape)).astype(np.float32)
    jm = JMesh(np.array(jax.devices()[:n]).reshape(mshape), axes)
    tm = tmesh.make_mesh(axes, mshape, devices=["cpu"] * n)
    kw = dict(axis_names=axes, krylov_m=M_KRY, variant="clean",
              apply_bc=apply_bc, **PARAMS)
    got = shards.gather(tspatial.make_sharded_nlse_step(
        kind, shape, LX, DT, tm, **kw)(shards.shard(u0, tm),
                                       shards.shard(mf, tm)), tm).numpy()

    def run():
        step = jspatial.make_sharded_nlse_step(
            kind, shape, LX, DT, jm, dtype=jnp.complex64, **kw)
        return np.asarray(step(jnp.asarray(u0), jnp.asarray(mf)))

    want = _jax_interpret(run)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    assert tk.phase_kick_bc_planar.launches == 0
