"""Milliseconds per batched step of the Lanczos loop's own host time: the
self time of the program's `nls.lanczos` spans (their length less that of
the spans inside them: the kernel wrappers' `nls.launch.*`), which is the
eager scalar recurrence between the kernels, over the traced call's steps.
The traced call's host runs slower under the profiler, so this reads high
against the untraced step. None where the trace holds no `nls.` span."""

from portbench.spans import program_spans, self_times


def read(rec):
    got = program_spans(rec)
    if got is None:
        return None
    own = sum(t for name, t in self_times(got[1]) if name == "nls.lanczos")
    return 1e3 * own / rec.traced_steps
