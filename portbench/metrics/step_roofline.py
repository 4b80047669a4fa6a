"""Percent of the window's wall time per batched step (host clock,
readback left out) that the least time of one step's algorithm takes
(portbench/roofline/step_<integrator>.py, step_ss2.py for SS2): the whole
step, whatever kernels implement it, and the host's gaps in it. None where
the configuration's integrator has no such file."""

from portbench.roofline import HERE, least_s, per_step


def read(rec):
    name = f"step_{rec.integrator}"
    if not rec.batches or not (HERE / f"{name}.py").is_file():
        return None
    _, nbytes, flops = per_step(name, rec.shape)
    return 100.0 * least_s(nbytes, flops) / rec.step_s
