"""Trajectory loop (port of nlsolvers_tpu/models/evolve.py::evolve).

Snapshot cadence as in the reference drivers (kg_driver.cpp:105-121):
snapshot 0 is the initial condition, snapshot k the state after
k*snapshot_freq steps. A plain Python loop: the JAX package's lax.scan has no
counterpart here (a CUDA graph of the step is later work, ROADMAP.md).
"""

import torch

__all__ = ["evolve"]


def evolve(step_fn, state0, num_snapshots, snapshot_freq, observe=None):
    """Run (num_snapshots-1) * snapshot_freq steps, recording snapshots.

    step_fn: (state, step_index) -> state; step_index counts from 1.
    observe: state -> snapshot tensor; defaults to identity.
    Returns the snapshots stacked on a leading axis of num_snapshots.
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
    return torch.stack(snaps)
