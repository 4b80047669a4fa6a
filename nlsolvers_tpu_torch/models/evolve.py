"""Trajectory loops (port of nlsolvers_tpu/models/evolve.py).

Snapshot cadence as in the reference drivers (kg_driver.cpp:105-121):
snapshot 0 is the initial condition, snapshot k the state after
k*snapshot_freq steps. Plain Python loops: the JAX package's lax.scan and
lax.while_loop have no counterpart here, and `simulate` is `evolve` (there
is no jit to take; a CUDA graph of the step is later work, ROADMAP.md).

A snapshot is a tensor or a tuple / list / dict of them (a real-wave
problem observes (u, v)); the stack keeps that structure, one stacked
tensor per leaf, as JAX maps over the tree.
"""

import torch

from nlsolvers_tpu_torch.parallel.mesh import lane_blocks
from nlsolvers_tpu_torch.utils.profiling import annotate

__all__ = ["evolve", "evolve_guarded", "evolve_lanes", "evolve_blocks",
           "lane_sums", "lanes_in_turn", "simulate", "tree_map"]


def tree_map(fn, *trees):
    """fn over the leaves (tensors) of equally structured trees (tuples,
    lists and dicts of tensors), as jax.tree.map."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def evolve(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """Run (num_snapshots-1) * snapshot_freq steps, recording snapshots.

    step_fn: (state, step_index) -> state; step_index counts from 1.
    observe: state -> snapshot (a tensor or a tree of them); defaults to
    identity. Returns the snapshots stacked on a leading axis of
    num_snapshots: one tensor, or the snapshot's tree of stacked tensors.
    Observing and stacking run in the span `nls.snapshot`.
    """
    if observe is None:
        observe = lambda s: s
    with annotate("nls.snapshot"):
        snaps = [observe(state0)]
    state, idx = state0, 1
    for _ in range(num_snapshots - 1):
        for i in range(snapshot_freq):
            state = step_fn(state, idx + i)
        idx += snapshot_freq
        with annotate("nls.snapshot"):
            snaps.append(observe(state))
    with annotate("nls.snapshot"):
        return tree_map(lambda *xs: torch.stack(xs), *snaps)


def evolve_guarded(step_fn, state0, num_snapshots, snapshot_freq,
                   observe=None, batched=False, scalars=None,
                   finite_reduce=None):
    """evolve() with a stability guard and an optional scalar series, the
    counterpart of the reference's on-device NaN check and energy kernels
    (device/sg_solver_dev.hpp:7-90).

    Every snapshot is checked for finite values on the device, and the run
    stops at the first snapshot at which every lane is non-finite. The
    checks, the exit flags and the series stay on the device: the loop
    reads one flag per snapshot (one host sync per snapshot, never one per
    step) to decide whether to go on. The snapshot and series copies run in
    the span `nls.snapshot`, the checks and the flag read in `nls.guard`
    (utils/profiling.annotate).

    batched: the leading axis of each observed leaf is the batch; finiteness
      reduces over the trailing axes only, per lane.
    scalars: optional {name: fn(state) -> scalar per lane}, recorded at
      every snapshot (entry 0 the initial condition).
    finite_reduce: optional reducer applied to the per-lane finite bits
      before they drive the exit (on a sharded grid it must combine every
      shard's bits, so that all shards stop together).

    Returns (snaps, bad_at, series): snaps as in evolve(), the snapshots
    after the exit zero-filled; bad_at int32 per lane, the index of the
    first non-finite snapshot, num_snapshots when the run stayed finite;
    series {name: (num_snapshots,) + lane shape}.
    """
    if observe is None:
        observe = lambda s: s
    scalars = scalars or {}
    S = num_snapshots

    def finite_of(snap):
        ok = None
        for x in _leaves(snap):
            fin = torch.isfinite(x)
            fin = (fin.reshape(fin.shape[0], -1).all(dim=1) if batched
                   else fin.all())
            ok = fin if ok is None else ok & fin
        if finite_reduce is not None:
            ok = finite_reduce(ok)
        return ok                       # (B,) bool, or a 0-d bool

    def buffer(x):
        buf = torch.zeros((S,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[0] = x
        return buf

    with annotate("nls.snapshot"):
        snap0 = observe(state0)
        bufs = tree_map(buffer, snap0)
        series = {k: buffer(torch.as_tensor(fn(state0)))
                  for k, fn in scalars.items()}
    with annotate("nls.guard"):
        ok = finite_of(snap0)
        bad_at = torch.where(ok, S, 0).to(torch.int32)
        go = S > 1 and bool(ok.any())
    state, s = state0, 1
    while go:
        idx0 = (s - 1) * snapshot_freq + 1
        for i in range(snapshot_freq):
            state = step_fn(state, idx0 + i)
        with annotate("nls.snapshot"):
            snap = observe(state)
            tree_map(lambda b, x: b[s].copy_(x), bufs, snap)
            for k, fn in scalars.items():
                series[k][s] = torch.as_tensor(fn(state))
        with annotate("nls.guard"):
            fin = finite_of(snap)
            bad_at = torch.where(ok & ~fin, s, bad_at).to(torch.int32)
            ok = ok & fin
            s += 1
            go = s < S and bool(ok.any())
    return bufs, bad_at, series


def evolve_lanes(step_fn, state0, num_snapshots, snapshot_freq, observe,
                 guard, scalars=None):
    """A batch of lanes, as the trajectory engines run it: evolve(), or
    with `guard` evolve_guarded() over the lanes (batched=True) with each
    series lane-major, (num_snapshots,) + lanes moved to lanes first.
    Returns (snaps, bad_at, series), bad_at and series None unguarded."""
    if not guard:
        return evolve(step_fn, state0, num_snapshots, snapshot_freq,
                      observe=observe), None, None
    snaps, bad_at, series = evolve_guarded(
        step_fn, state0, num_snapshots, snapshot_freq, observe=observe,
        batched=True, scalars=scalars)
    return snaps, bad_at, {k: v.movedim(0, 1) for k, v in series.items()}


def lanes_in_turn(lane_steps):
    """step(states, i) of a batch whose lanes step one after the other:
    `states` is a batched state (a tensor, or a tree of them, with the
    lanes leading), lane b stepped by lane_steps[b] and the lanes stacked
    again. A lane whose eigensolver fails (its state has diverged; torch
    raises where JAX's eigh returns NaN) is NaN from then on, as JAX's
    vmapped lane, and is not stepped again."""
    dead = [False] * len(lane_steps)

    def step(states, i):
        out = []
        for b, lane in enumerate(lane_steps):
            s = tree_map(lambda x: x[b], states)
            if dead[b]:
                out.append(s)
                continue
            try:
                out.append(lane(s, i))
            except torch.linalg.LinAlgError:
                dead[b] = True
                out.append(tree_map(lambda x: torch.full_like(x, float("nan")),
                                    s))
        return tree_map(lambda *xs: torch.stack(xs), *out)

    return step


def lane_sums(x):
    """Each lane's sum of a (B, ...) tensor, one reduction per lane: the
    card orders a reduction over the trailing dimensions by the batch's
    shape, so a lane's sum would change with its batch; alone it does
    not."""
    return torch.stack([torch.sum(v) for v in x])


def evolve_blocks(setup, devices, fields, num_snapshots, snapshot_freq,
                  observe, guard, scalars=None):
    """evolve_lanes over the lane blocks of a batch, one block per device:
    setup(*block_fields, lane0, device) -> (states, step) of the block
    whose first lane is lane lane0 of the batch, `fields` the batched
    inputs (a tensor, a tree of them, or None where absent) cut by
    parallel/mesh.lane_blocks, one block per device. One block is evolved as it
    is; several step one after the other inside each step, in one loop
    (the guard's exit is the whole batch's), their snapshots and series
    joined on the first device. The blocks' setup runs in the span
    `nls.setup`."""
    B = _leaves(fields[0])[0].shape[0]
    with annotate("nls.setup"):
        parts = [setup(*[None if f is None else tree_map(lambda x: x[sl], f)
                         for f in fields], sl.start, dev)
                 for sl, dev in zip(lane_blocks(B, len(devices)), devices)]
    if len(parts) == 1:
        states, step = parts[0]
        return evolve_lanes(step, states, num_snapshots, snapshot_freq,
                            observe, guard, scalars)
    steps = [f for _, f in parts]

    def joined(fn):
        return lambda st: tree_map(
            lambda *xs: torch.cat([x.to(devices[0]) for x in xs]),
            *[fn(s) for s in st])

    return evolve_lanes(
        lambda st, i: [f(s, i) for f, s in zip(steps, st)],
        [s for s, _ in parts], num_snapshots, snapshot_freq, joined(observe),
        guard, {k: joined(fn) for k, fn in (scalars or {}).items()})


def simulate(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """evolve(): the JAX package's jitted entry point; the port has no jit,
    so it runs the same loop."""
    return evolve(step_fn, state0, num_snapshots, snapshot_freq, observe)
