"""Trajectory-steps completed per second: B x steps per trajectory x whole
batches, over the window's wall time from the first dispatch to the last
batch's snapshots on the host (host clock)."""


def read(rec):
    steps = rec.shape.B * rec.steps_per_traj * len(rec.batches)
    return steps / rec.window_s if rec.window_s > 0 else None
