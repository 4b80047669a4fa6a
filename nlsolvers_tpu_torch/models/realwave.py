"""Real-wave steppers (port of nlsolvers_tpu/models/realwave.py).

Every real-wave equation of the suite has the form

    u_tt = Lap_c u - m(x) g(u)          (Lap_c = div(c grad .) or plain Lap)

with g from models/nonlinearities.py; the two-step schemes carry
(u, u_past). Parity map:
  gautschi_step        <-> SGESolver::step (sg_single_solver.hpp:42-59),
                           KGESolver::step (kg_solver.hpp:12-22) and the
                           phi4 / double / hyperbolic solvers:
      u' = 2 cos(dt W) u - u_past + dt^2 sinc^2(dt/2 W) (-m g(F u))
      with W = sqrt(|L|) by Lanczos and the filter F mod_cosine (single
      sine-Gordon) or id_sqrt (= dt W, the rest). The filter and the cosine
      share one Lanczos run of u (matfunc_apply_multi), so a step runs two
      matrix functions where the reference runs three.
  sv_step              <-> SGESolverSV (sg_single_sv_solver.hpp:7-20),
                           KGESVSolver, Phi4SVSolver:
      u' = 2u - u_past + dt^2 (Lap u - m g(u))
  stochastic_sv_step   <-> device::SP4Solver::step (stochastic_phi4.cuh:
                           19-80): the SV step with white noise in the force,
                           -m (u - u^3 + sigma xi).

All the matrix functions take |lambda|, so the operator's sign does not
matter; the problems pass -Lap, whose descriptor (sign flipped) sends real
float32 fields through the fused kernels at P=1 (ops/krylov._fused_path).
`gautschi_step_sharded` is the float32 Gautschi step on a sharded grid
(parallel/shards.py) through the shard kernels, at P=1 with a shard
descriptor of -Lap.

Noise. The JAX package draws xi inside its step from
jax.random.fold_in(PRNGKey(seed), step_index), which torch's generators
cannot replay. Here `stochastic_sv_step` takes xi as an argument, and
`stochastic_noise` draws it on the state's device from a torch.Generator
seeded from (seed, step_index): one seed gives the same trajectory on the
same device, as in JAX, but the numbers are not JAX's. Parity with the JAX
step is shown by passing it JAX's xi.
"""

import numpy as np
import torch

from nlsolvers_tpu_torch.config import default_krylov_m
from nlsolvers_tpu_torch.ops.krylov import matfunc_apply, matfunc_apply_multi

__all__ = ["gautschi_step", "gautschi_step_sharded", "sv_step",
           "stochastic_sv_step", "stochastic_noise", "gautschi_filter"]


def gautschi_filter(kind):
    """The Gautschi filter F of a real-wave kind: mod_cosine for single
    sine-Gordon (sg_single_solver.hpp:52), id_sqrt for the rest."""
    return "mod_cosine" if kind == "sine_gordon" else "id_sqrt"


def gautschi_step(u, u_past, omega2, m_field, g_fn, dt, m=default_krylov_m,
                  filter_func="id_sqrt", reorth=True, mesh=None):
    """One Gautschi step; returns (u_new, u). `omega2` applies L = Omega^2
    (either sign); `filter_func` is "mod_cosine" for single sine-Gordon
    (sg_single_solver.hpp:52) or "id_sqrt" for the rest. With `mesh` (the
    JAX package's axis_names), u, u_past and m_field are sharded fields,
    omega2 maps one to one, and the matrix functions are the sharded
    generic Lanczos (ops/krylov.py): the float64 and reorth=False sharded
    Gautschi."""
    fu, cu = matfunc_apply_multi(omega2, u,
                                 ((dt, filter_func), (dt, "cos_sqrt")),
                                 m=m, reorth=reorth, mesh=mesh)
    if mesh is None:
        b = -(m_field * g_fn(fu))
    else:
        b = [-(mk * g_fn(f)) for mk, f in zip(m_field, fu)]
    s2 = matfunc_apply(omega2, b, dt, "sinc2_sqrt_half", m=m, reorth=reorth,
                       mesh=mesh)
    if mesh is None:
        return 2.0 * cu - u_past + (dt * dt) * s2, u
    return [2.0 * c - up + (dt * dt) * s for c, up, s in zip(cu, u_past,
                                                             s2)], u


def gautschi_step_sharded(us, us_past, desc, m_fields, g_fn, dt,
                          m=default_krylov_m, filter_func="id_sqrt"):
    """gautschi_step on a sharded float32 grid, in its arithmetic order:
    `us`, `us_past` and `m_fields` hold each shard's ([B,] *block) tensors,
    `desc` is the shard descriptor of Omega^2 = -Lap (sign flipped, weight
    tensors shared: models/problems._negated's rule). Each matrix function
    is one sharded Lanczos run on the ([B,] 1, R, nx) views
    (parallel/lanczos.py), the filter and the cosine from one run. Returns
    (u_new, us); the ghost copy is the caller's."""
    from nlsolvers_tpu_torch.parallel.lanczos import (
        matfunc_apply_sharded_multi)
    from nlsolvers_tpu_torch.parallel.shards import per_shard

    mesh = desc["mesh"]
    nx = us[0].shape[-1]
    lead = tuple(us[0].shape[:-3 if desc["kind"].startswith("shard3d")
                            else -2])

    def views(fields):
        return [f.reshape(lead + (1, -1, nx)) for f in fields]

    def back(fields):
        return [f.reshape(us[0].shape) for f in fields]

    fu, cu = map(back, matfunc_apply_sharded_multi(
        views(us), desc, ((dt, filter_func), (dt, "cos_sqrt")), m))
    b = per_shard(mesh, lambda k: -(m_fields[k] * g_fn(fu[k])))
    s2, = map(back, matfunc_apply_sharded_multi(
        views(b), desc, ((dt, "sinc2_sqrt_half"),), m))
    return per_shard(mesh, lambda k: 2.0 * cu[k] - us_past[k]
                     + (dt * dt) * s2[k]), us


def sv_step(u, u_past, lap, m_field, g_fn, dt):
    """One Stormer-Verlet step; returns (u_new, u). `lap` applies +Lap."""
    accel = lap(u) - m_field * g_fn(u)
    return 2.0 * u - u_past + (dt * dt) * accel, u


def stochastic_sv_step(u, u_past, xi, lap, m_field, dt, noise_strength):
    """One stochastic phi-4 SV step with the noise field `xi` (N(0, 1) per
    point); returns (u_new, u). Force: Lap u - m (u - u^3 + sigma xi)
    (stochastic_phi4.cuh:38-53)."""
    accel = lap(u) - m_field * (u - u ** 3 + noise_strength * xi)
    return 2.0 * u - u_past + (dt * dt) * accel, u


def _step_seed(seed, step_index, sample=None):
    """A 63-bit generator seed mixed from (seed, step_index) or, for one
    trajectory of a batch, (seed, step_index, sample)."""
    entropy = [int(seed), int(step_index)]
    if sample is not None:
        entropy.append(int(sample))
    state = np.random.SeedSequence(entropy)
    return int(state.generate_state(1, np.uint64)[0]) >> 1


def stochastic_noise(seed, step_index, like, generator=None, sample=None):
    """xi ~ N(0, 1) of `like`'s shape, dtype and device, drawn from a
    torch.Generator on that device seeded from (seed, step_index) and, for
    trajectory `sample` of a batch (the datagen engine), that index too:
    the same key gives the same field, another step or sample another one.
    Pass a `generator` of that device to reuse it (it is re-seeded)."""
    if generator is None:
        generator = torch.Generator(device=like.device)
    generator.manual_seed(_step_seed(seed, step_index, sample))
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)
