"""Kernel launches per batched step inside the program's `nls.eigh` spans
(host launch events cudaLaunch*, cuLaunch*: T's build, the mask and
cuSOLVER's kernels), over the traced call's steps. A count, which the
profiler's slowing of the host does not move. None where the trace holds
no `nls.` span."""

from portbench.spans import launches_under, program_spans


def read(rec):
    got = program_spans(rec)
    if got is None:
        return None
    return launches_under(*got, "nls.eigh") / rec.traced_steps
