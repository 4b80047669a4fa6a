"""Kernel launches per batched step that the Lanczos loop makes itself:
host launch events (cudaLaunch*, cuLaunch*) inside an `nls.lanczos` span
and under no deeper `nls.` span (so not a hand kernel's wrapper), over the
traced call's steps: torch's kernels of the scalar recurrence. A count,
which the profiler's slowing of the host does not move. None where the
trace holds no `nls.` span."""

from portbench.spans import launches_under, program_spans


def read(rec):
    got = program_spans(rec)
    if got is None:
        return None
    return launches_under(*got, "nls.lanczos") / rec.traced_steps
