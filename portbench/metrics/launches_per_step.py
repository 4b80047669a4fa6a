"""Kernel launches per batched step: the kernel rows of the traced call
(3 snapshots; its per-snapshot guard and buffer work included) over its
steps."""


def read(rec):
    if rec.trace is None or not rec.traced_steps:
        return None
    return len(rec.trace.kernels()) / rec.traced_steps
