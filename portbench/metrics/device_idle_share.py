"""Share of a batched step in which nothing runs on the device: 1 - the
device's busy time per step in the traced call (the union of its kernel,
memcpy and memset intervals over its steps) over the window's wall time per
step (host clock, readback left out). The profiler slows the host, not the
kernels, so the window's step, and not the traced one, is the base."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.traced_steps or not rec.batches:
        return None
    return 1.0 - tr.busy_s() / rec.traced_steps / rec.step_s
