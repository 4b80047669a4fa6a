"""Batched trajectory engine (port of nlsolvers_tpu/pipeline/engine.py).

A datagen batch is B trajectories, each with its own coefficient fields m(x)
and c(x). The JAX package maps one step over the batch with jax.vmap inside
one jitted scan, and models/evolve carries the batch here as there: the
snapshot cadence, the guard (one flag per snapshot across the batch, early
exit only when every lane has diverged) and the scalar series are JAX's.

Every planar NLSE step and the float32 real-wave Gautschi step run as ONE
batched step, as JAX's vmap: the NLSE SS2 step and the two-step
integrators (sEWI, fused sEWI, Gautschi) on the planar path (complex64, 2D
or 3D; the production datagen steps) and the real-wave Gautschi step with
the fused kernels (2D or 3D). The state is a (B, 2, R, nx) float32 tensor
(NLSE SS2), a pair of them (the two-step integrators: (u, u_prev), step
index 1 the batched SS2 bootstrap) or a pair of (B, *shape) float32
tensors (real-wave), and each kernel of the step is one launch over all
lanes (ops/cuda/lanczos2d.py, lanczos3d.py, kick.py, bc3d.py; under
config.fused_iter the batched K5, under config.pipeline_3d the batched K8),
with the scalar recurrence on (B, ...) tensors and one batched eigh
(ops/krylov.py). A two-step step's ghost copy follows it: the plain copy in
2D, one batched bc3d in place in 3D. The operator (the lanes' c(x) face
weights stacked, or the shared Laplacian; sign-flipped for the real-wave
step, as models/problems._negated flips it) and the lanes' m are built once
per batch. Each lane takes the unbatched kernels' bits and arithmetic, and
the batched eigh gives each lane's T the single-matrix eigh's bits (torch
2.11 with CUDA 12.8 on an H100, and the CPU; chip_smoke.py and the card
tests check it), so a lane equals nlse_problem or realwave_problem run
alone bit for bit. A lane whose T is not finite gets NaN coefficients from
the batched eigh, as from JAX's, and stays NaN; the guard flags it.

Every other path (the complex NLSE path, float64, SV, stochastic phi-4)
keeps one problem from models/problems.py per trajectory (nlse_problem,
realwave_problem), built once per call of the trajectory function, and a
batched step advances every trajectory by one step in turn; a lane's
trajectory there equals the problem run alone with its fields, bit for
bit. A lane whose state has gone non-finite can make the tridiagonal
eigensolver fail (torch raises where JAX returns NaN); the engine then
keeps that lane's state as NaN, which is what JAX's vmapped step carries,
and the guard flags it.

Trajectory functions return snapshot stacks shaped (B, S, ...) where entry
s=0 is the initial condition, as tensors on the engine's device. Inputs may
be numpy arrays or tensors.

`mesh` with `batch_axis` splits the batch over the mesh's batch axis, as
JAX's shard_batch does (pipeline/engine.py:244-256, 370-380): lane block b
(parallel/mesh.lane_blocks) runs on the first device of batch index b, as
one batched step of its lanes there (or its lanes in turn, off the planar
path), and one loop steps every block, so the guard's early exit is the
whole batch's, as in JAX's one program (models/evolve.evolve_blocks).
Each lane keeps the bits it has without a mesh, its mass or energy series
too: the series sums each lane alone (models/evolve.lane_sums). The
outputs are joined on the first block's device.
"""

import numpy as np
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.config import real_dtype_of, torch_dtype
from nlsolvers_tpu_torch.models import problems
from nlsolvers_tpu_torch.models import realwave as rw
from nlsolvers_tpu_torch.models.evolve import (evolve_blocks, lane_sums,
                                               lanes_in_turn, tree_map)
from nlsolvers_tpu_torch.models.nonlinearities import (NLSE_KINDS,
                                                       REALWAVE_KINDS,
                                                       nlse_density_planar,
                                                       realwave_g,
                                                       realwave_potential)
from nlsolvers_tpu_torch.ops import boundaries as bcs
from nlsolvers_tpu_torch.ops import operators as ops
from nlsolvers_tpu_torch.ops.cuda.bc3d import neumann_bc_planar_3d
from nlsolvers_tpu_torch.ops.cuda.lanczos2d import (matfunc_apply_planar_multi,
                                                    supported_desc)
from nlsolvers_tpu_torch.parallel.mesh import batch_blocks

__all__ = ["make_nlse_trajectory_fn", "make_realwave_trajectory_fn",
           "torch_dtype"]


def _tensor(x, device, dtype=None):
    """x (numpy or tensor) on `device`; its own dtype unless one is given."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _block_devices(mesh, batch_axis, device):
    """The device of each lane block: `device` alone without a mesh, else
    the first device of each batch index's sub-mesh."""
    if mesh is None:
        return [torch.device(device)]
    return [sub.devices[0] for sub, _ in batch_blocks(mesh, batch_axis)]


def _batched_operator(shape, dx, c, B, variant, rdtype, device):
    """The kernel descriptor of the B lanes' operator: their c(x) face
    weights stacked (operators.batched_aniso_laplacian_2d / _3d), or, with
    c None, the shared Laplacian's; each lane's bits are those of the
    operator problems.nlse_problem builds for it alone."""
    if c is None:
        return problems._nlse_operator(shape, dx, None, variant, rdtype,
                                       device).kernel_desc
    cs = [c[b] for b in range(B)]
    if len(shape) == 2:
        return ops.batched_aniso_laplacian_2d(cs, dx, dx, device=device)
    return ops.batched_aniso_laplacian_3d(cs, dx, variant=variant,
                                          device=device)


def _without_resident(build):
    """build() with config.resident_mode off: the JAX engine never takes
    the resident SS2 kernel."""
    old = config.resident_mode
    config.resident_mode = "off"
    try:
        return build()
    finally:
        config.resident_mode = old


def make_nlse_trajectory_fn(kind, shape, Lx, dt, *, integrator="ss2",
                            krylov_m=10, sigma1=1.0, sigma2=-0.1, kappa=1.0,
                            dtype=torch.complex64, variant="reference",
                            apply_bc=True, reorth=True, use_c=True,
                            mesh=None, batch_axis="batch", guard=False,
                            record_energy=False, boundary="noflux",
                            device="cuda"):
    """Builds traj(u0_packed, m, c, num_snapshots, snapshot_freq).

    u0_packed: (B, 2, *shape) real — stacked (real, imag) per trajectory.
    m, c:      (B, *shape) real coefficient fields (c ignored if use_c=False).
    Returns    (B, S, 2, *shape) real — packed complex snapshot stacks.

    With guard=True: (snaps, bad_at[, series]) where bad_at is (B,) int32
    (= S when the lane stayed finite) and, with record_energy=True,
    series = {"mass": (B, S)}, mass = sum |u|^2 dV recorded on the device.

    Each lane is nlse_problem(kind, shape, Lx, dt, m_field=m[b],
    c_field=c[b], ...) on `device` (with `mesh`, on its lane block's device:
    module docstring): complex64 with the no-flux or no BC
    takes the planar path when the kernels support the operator, which the
    trajectory function's `planar` attribute says (probed at build with
    c = 1, as JAX probes its Pallas gate; the port has no 128-lane gate).
    An SS2 step's closing half kick does the ghost copy; the two-step
    integrators copy it after their step and bootstrap with one SS2 step at
    index 1. `dtype` is a torch dtype or a numpy one. On the planar path
    (2D and 3D, every integrator) all lanes run as one batched step (the
    `batched` attribute), the complex path lane by lane (module docstring).
    """
    if kind not in NLSE_KINDS:
        raise ValueError(f"unknown NLSE kind {kind!r}")
    if boundary not in ("noflux", "radiating", "none"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if boundary == "radiating" and len(shape) != 2:
        raise ValueError("radiating BC is 2D only (boundaries.hpp:59)")
    devices = _block_devices(mesh, batch_axis, device)
    dtype = torch_dtype(dtype)
    rdtype = real_dtype_of(dtype)
    shape = tuple(int(n) for n in shape)
    nx = shape[-1]
    dV = (2.0 * Lx / (nx - 1)) ** len(shape)
    # JAX's engine: the radiating BC whatever apply_bc says, the no-flux
    # ghost copy only with apply_bc
    bc = ("radiating" if boundary == "radiating"
          else "noflux" if boundary == "noflux" and apply_bc else "none")
    two_state = integrator != "ss2"

    def lane_problem(m_b, c_b, dev):
        return _without_resident(lambda: problems.nlse_problem(
            kind, shape, Lx, dt, m_field=m_b, c_field=c_b, sigma1=sigma1,
            sigma2=sigma2, kappa=kappa, integrator=integrator,
            krylov_m=krylov_m, dtype=dtype, variant=variant, reorth=reorth,
            bc=bc, device=dev))

    dev0 = devices[0]
    probe = lane_problem(torch.zeros(shape, dtype=rdtype, device=dev0),
                         torch.ones(shape, dtype=rdtype, device=dev0)
                         if use_c else None, dev0)
    planar = probe.meta["planar_state"]
    del probe
    R = int(np.prod(shape[:-1]))

    def batch_step(m, c, B, dev):
        """nlse_problem's planar step of all B lanes at once, on a (B, 2,
        R, nx) state (a pair of them for a two-step integrator), its
        operator and density built per lane as nlse_problem builds them and
        stacked."""
        dx = 2.0 * Lx / (nx - 1)
        desc = _batched_operator(shape, dx, c, B, variant, rdtype, dev)
        m2 = m.to(rdtype).to(torch.float32).reshape(B, R, nx).contiguous()
        rho = nlse_density_planar(kind, m2, sigma1=sigma1, sigma2=sigma2,
                                  kappa=kappa)
        return problems.planar_step(integrator, shape, dt, krylov_m, desc,
                                    rho, bc)

    def first(s):
        return s[0] if two_state else s

    def observe(states):
        return first(states)

    def mass_of(states):
        u = first(states)
        return lane_sums(u * u if planar else torch.abs(u) ** 2) * dV

    def pack(snaps):
        snaps = snaps.movedim(0, 1)             # (B, S, ...)
        if planar:                              # (B, S, 2, R, nx)
            return snaps.reshape(snaps.shape[:3] + shape)
        return torch.stack([snaps.real, snaps.imag], dim=2)

    def setup(packed, m, c, lane0, dev):
        """(states, step) of a block of lanes on dev."""
        del lane0
        packed = _tensor(packed, dev, rdtype)
        m = _tensor(m, dev)
        c = _tensor(c, dev) if use_c else None
        B = packed.shape[0]
        if planar:
            states = packed.to(torch.float32).reshape(B, 2, R,
                                                      nx).contiguous()
            if two_state:
                states = (states, states)
            return states, batch_step(m, c, B, dev)
        probs = [lane_problem(m[b], None if c is None else c[b], dev)
                 for b in range(B)]
        states = tree_map(lambda *xs: torch.stack(xs), *[
            p.init(torch.complex(packed[b, 0], packed[b, 1]))
            for b, p in enumerate(probs)])
        return states, lanes_in_turn([p.step for p in probs])

    def traj(u0_packed, m, c, num_snapshots, snapshot_freq):
        scalars = {"mass": mass_of} if record_energy else None
        snaps, bad_at, series = evolve_blocks(
            setup, devices, (u0_packed, m, c if use_c else None),
            num_snapshots, snapshot_freq, observe, guard, scalars)
        if not guard:
            return pack(snaps)
        return (pack(snaps), bad_at) + ((series,) if record_energy else ())

    traj.planar = planar
    traj.batched = planar
    return traj


def make_realwave_trajectory_fn(kind, shape, Lx, dt, *, integrator="gautschi",
                                krylov_m=10, noise_strength=0.0, seed=0,
                                dtype=torch.float32, variant="reference",
                                apply_bc=True, reorth=True, use_c=True,
                                mesh=None, batch_axis="batch", guard=False,
                                record_energy=False, device="cuda"):
    """Builds traj(u0, v0, m, c, num_snapshots, snapshot_freq).

    u0, v0, m, c: (B, *shape) real. Returns (u_traj, v_traj), each
    (B, S, *shape): the field and its finite-difference velocity
    v = (u - u_past)/dt (kg_driver.cpp:112).

    guard=True appends bad_at (B,) int32 to the return; record_energy=True
    additionally appends {"energy": (B, S)}, the discrete energy
    sum (v^2/2 + |grad u|^2/2 + V(u)) dV with torch.gradient's central
    differences (numpy's edge order).

    Each lane is realwave_problem(kind, ..., m_field=m[b], c_field=c[b]) on
    `device` (with `mesh`, its lane block's device: module docstring): a
    float32 Gautschi step runs its two matrix functions on -Lap
    (the sign-flipped descriptor) through the fused kernels, all lanes in
    one batched step (2D and 3D, the `batched` attribute; module
    docstring); the other steps run lane by lane. kind may also
    be "stochastic_phi4": the SV step with white noise, on div(c grad u)
    when use_c, its noise drawn per (sample, step) from a torch.Generator
    seeded from (seed, i, b) (models/realwave.stochastic_noise). One seed
    gives the same batch; the noise is not JAX's, whose
    fold_in(fold_in(PRNGKey(seed), i), b) torch cannot replay.
    """
    stochastic = kind == "stochastic_phi4"
    if not stochastic and kind not in REALWAVE_KINDS:
        raise ValueError(f"unknown real-wave kind {kind!r}")
    devices = _block_devices(mesh, batch_axis, device)
    dtype = torch_dtype(dtype)
    rdtype = real_dtype_of(dtype)
    shape = tuple(int(n) for n in shape)
    dim, nx = len(shape), shape[-1]
    dx = 2.0 * Lx / (nx - 1)
    dV = dx ** dim
    potential = realwave_potential(kind)
    R = int(np.prod(shape[:-1]))
    batched = False
    if not stochastic and integrator == "gautschi" and reorth and \
            rdtype == torch.float32:
        probe = problems._nlse_operator(
            shape, dx, torch.ones(shape, dtype=rdtype, device=devices[0])
            if use_c else None, variant, rdtype, devices[0])
        batched = supported_desc(getattr(probe, "kernel_desc", None), shape,
                                 torch.float32)
        del probe

    def batch_step(m, c, B, device):
        """realwave_problem's float32 Gautschi step (rw.gautschi_step's
        arithmetic in its order) on all B lanes at once: each matrix
        function one batched fused-kernel run on the (B, 1, R, nx) view of
        -Lap (the lanes' operators stacked, the sign flipped), then the
        ghost copy: the plain one in 2D, one batched bc3d in place on the
        fresh u_new in 3D. The planar path is called directly: a (B, ny,
        nx) field would pass for a 3D one in ops/krylov's dispatch."""
        desc = _batched_operator(shape, dx, c, B, variant, rdtype, device)
        desc = dict(desc, sign=-desc["sign"])
        m_t = m.to(rdtype)
        g = realwave_g(kind)
        filt = rw.gautschi_filter(kind)
        view = (B, 1, R, nx)

        def matfuncs(u, specs):
            return [o.reshape(u.shape) for o in matfunc_apply_planar_multi(
                u.reshape(view), desc, specs, krylov_m)]

        def neumann(u):
            if not apply_bc:
                return u
            if dim == 2:
                return bcs.neumann_no_velocity_2d(u)
            neumann_bc_planar_3d(u.view(view), shape)
            return u

        def step(state, i):
            del i
            u, u_past = state
            fu, cu = matfuncs(u, ((dt, filt), (dt, "cos_sqrt")))
            b = -(m_t * g(fu))
            s2, = matfuncs(b, ((dt, "sinc2_sqrt_half"),))
            return neumann(2.0 * cu - u_past + (dt * dt) * s2), u

        return step

    def stochastic_lane(m_b, c_b, b, device):
        lap = problems._nlse_operator(shape, dx, c_b, variant, rdtype,
                                      device)
        neumann = problems._real_neumann(shape, rdtype, apply_bc)
        m_t = m_b.to(rdtype)
        gen = torch.Generator(device=device)

        def step(state, i):
            u, u_past = state
            xi = rw.stochastic_noise(seed, i, u, generator=gen, sample=b)
            u_new, u_past_new = rw.stochastic_sv_step(
                u, u_past, xi, lap, m_t, dt, noise_strength)
            return neumann(u_new), u_past_new

        return step

    def lane_step(m_b, c_b, b, device):
        if stochastic:
            return stochastic_lane(m_b, c_b, b, device)
        return problems.realwave_problem(
            kind, shape, Lx, dt, m_field=m_b, c_field=c_b,
            integrator=integrator, krylov_m=krylov_m, dtype=dtype,
            variant=variant, apply_bc=apply_bc, reorth=reorth,
            device=device).step

    def observe(states):
        u, u_past = states
        return u, (u - u_past) / dt

    def energy_of(states):
        """Each lane's energy of a (B, *shape) batch."""
        u, u_past = states
        axes = tuple(range(u.dim() - dim, u.dim()))
        v = (u - u_past) / dt
        grad2 = sum(torch.gradient(u, spacing=dx, dim=a)[0] ** 2
                    for a in axes)
        dens = 0.5 * v ** 2 + 0.5 * grad2 + potential(u)
        return lane_sums(dens) * dV

    def setup(u0, v0, m, c, lane0, device):
        """(states, step) of a block of lanes on `device`, its first lane
        lane0 of the batch (the stochastic noise's sample index)."""
        u0 = _tensor(u0, device, rdtype)
        v0 = _tensor(v0, device, rdtype)
        m = _tensor(m, device)
        c = _tensor(c, device) if use_c else None
        B = u0.shape[0]
        past = u0 - dt * v0                  # u_past = u0 - dt v0
        if batched:
            return (u0.contiguous(), past), batch_step(m, c, B, device)
        return (u0, past), lanes_in_turn([lane_step(
            m[b], None if c is None else c[b], lane0 + b, device)
            for b in range(B)])

    def traj(u0, v0, m, c, num_snapshots, snapshot_freq):
        scalars = {"energy": energy_of} if record_energy else None
        (u_s, v_s), bad_at, series = evolve_blocks(
            setup, devices, (u0, v0, m, c if use_c else None),
            num_snapshots, snapshot_freq, observe, guard, scalars)
        out = (u_s.movedim(0, 1), v_s.movedim(0, 1))
        if not guard:
            return out
        return out + (bad_at,) + ((series,) if record_energy else ())

    traj.batched = batched
    return traj
