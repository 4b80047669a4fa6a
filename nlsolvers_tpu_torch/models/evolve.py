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

__all__ = ["evolve", "evolve_guarded", "evolve_lanes", "simulate"]


def _map(fn, *trees):
    """fn over the leaves (tensors) of equally structured trees."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
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
    """
    if observe is None:
        observe = lambda s: s
    snaps = [observe(state0)]
    state, idx = state0, 1
    for _ in range(num_snapshots - 1):
        for i in range(snapshot_freq):
            state = step_fn(state, idx + i)
        idx += snapshot_freq
        snaps.append(observe(state))
    return _map(lambda *xs: torch.stack(xs), *snaps)


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
    step) to decide whether to go on.

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

    snap0 = observe(state0)
    bufs = _map(buffer, snap0)
    series = {k: buffer(torch.as_tensor(fn(state0)))
              for k, fn in scalars.items()}
    ok = finite_of(snap0)
    bad_at = torch.where(ok, S, 0).to(torch.int32)
    state, s = state0, 1
    while s < S and bool(ok.any()):
        idx0 = (s - 1) * snapshot_freq + 1
        for i in range(snapshot_freq):
            state = step_fn(state, idx0 + i)
        snap = observe(state)
        _map(lambda b, x: b[s].copy_(x), bufs, snap)
        for k, fn in scalars.items():
            series[k][s] = torch.as_tensor(fn(state))
        fin = finite_of(snap)
        bad_at = torch.where(ok & ~fin, s, bad_at).to(torch.int32)
        ok = ok & fin
        s += 1
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


def simulate(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """evolve(): the JAX package's jitted entry point; the port has no jit,
    so it runs the same loop."""
    return evolve(step_fn, state0, num_snapshots, snapshot_freq, observe)
