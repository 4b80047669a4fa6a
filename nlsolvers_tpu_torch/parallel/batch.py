"""Trajectory-batch parallelism (port of nlsolvers_tpu/parallel/batch.py).

The reference farms one trajectory per MPI rank or SLURM array task
(device/submit_nlse.py:80-137, finalized_scripts/nlse_2d_launch.sh). The
JAX package makes the batch a leading array axis, vmaps the step over it
and shards that axis over a mesh's "batch" axis with no communication. The
port keeps the leading axis: a batched state is the problem's state with a
lane axis in front (a tensor, or a tuple of them), a planar problem steps
all its lanes in one batched step (one launch per kernel), any other
problem steps them in turn, and a mesh's batch axis splits the lanes into
blocks, each on its batch index's device.
"""

import torch

from nlsolvers_tpu_torch.models.evolve import (evolve, evolve_blocks,
                                               lanes_in_turn, tree_map)
from nlsolvers_tpu_torch.parallel.mesh import batch_blocks, lane_blocks

__all__ = ["batched_step", "batched_evolve", "shard_batch"]


def _lanes(states):
    """The number of lanes of a batched state."""
    while isinstance(states, (tuple, list)):
        states = states[0]
    return states.shape[0]


def batched_step(problem):
    """The problem's step over a leading batch axis, the step index shared
    (JAX's vmap of problem.step): the problem's batched planar step where
    it has one (`problem.step.batched`, models/problems.planar_step on B
    lanes), else the lanes stepped in turn (a lane whose eigensolver fails
    is NaN from then on, models/evolve.lanes_in_turn)."""
    batched = getattr(problem.step, "batched", None)
    steps = {}

    def step(states, i):
        B = _lanes(states)
        if B not in steps:
            steps[B] = (batched(B) if batched is not None
                        else lanes_in_turn([problem.step] * B))
        return steps[B](states, i)

    return step


def shard_batch(tree, mesh, batch_axis="batch"):
    """A batched tree (tensors with a leading lane axis, in a tuple, list or
    dict) placed over the mesh's batch axis: each tensor becomes a list over
    the mesh's shards, shard k holding the lanes of its batch index
    (parallel/mesh.lane_blocks) on its device, replicated over the other
    axes, as JAX's P(batch_axis). Raises ValueError when the axis does not
    divide the lanes."""
    blocks = batch_blocks(mesh, batch_axis)

    def put(x):
        out = [None] * mesh.size
        for (_, ks), sl in zip(blocks, lane_blocks(x.shape[0], len(blocks))):
            for k in ks:
                out[k] = x[sl].to(mesh.devices[k], copy=True)
        return out

    return tree_map(put, tree)


def batched_evolve(problem, states0, num_snapshots, snapshot_freq,
                   mesh=None, batch_axis="batch", jit=True):
    """Evolve a batch of trajectories; snapshots get shape (B, S, ...).

    `states0` is the batched state (leading axis = trajectory: the stack of
    problem.init's states). With a mesh, the lanes are split over its batch
    axis: each block steps as one batched step on its batch index's first
    device, one loop stepping every block (models/evolve.evolve_blocks),
    with no traffic between blocks. The problem's tensors live on one
    device, so every block's device must be the problem's (build one
    problem per device otherwise). `jit` is the JAX package's argument; the
    port has no jit and runs the same loop."""
    del jit
    observe = _map_observe(problem)
    if mesh is None:
        snaps = evolve(batched_step(problem), states0, num_snapshots,
                       snapshot_freq, observe=observe)
    else:
        devices = [sub.devices[0] for sub, _ in batch_blocks(mesh, batch_axis)]
        snaps, _, _ = evolve_blocks(
            lambda st, lane0, dev: (tree_map(lambda x: x.to(dev), st),
                                    batched_step(problem)),
            devices, (states0,), num_snapshots, snapshot_freq, observe,
            guard=False)
    return tree_map(lambda x: x.movedim(0, 1), snaps)


def _map_observe(problem):
    """problem.observe on each lane of a batched state, stacked (JAX's
    vmap of problem.observe)."""
    def observe(states):
        B = _lanes(states)
        snaps = [problem.observe(tree_map(lambda x: x[b], states))
                 for b in range(B)]
        return tree_map(lambda *xs: torch.stack(xs), *snaps)

    return observe
