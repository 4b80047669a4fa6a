"""Percent of the window's wall time per batched step (host clock,
readback left out) that the least time of one SS2 step's algorithm takes
(portbench/roofline/step_ss2.py): the whole step, whatever kernels
implement it, and the host's gaps in it."""

from portbench.roofline import least_s, per_step


def read(rec):
    if not rec.batches:
        return None
    _, nbytes, flops = per_step("step_ss2", rec.shape)
    return 100.0 * least_s(nbytes, flops) / rec.step_s
