"""Share of the traced call's device idle time (Trace.idle_gaps(): the
window's stretches with nothing on the device) whose gap midpoint lies in
no `nls.` span of the program: the idle time that the spans do not yet
name. Times are the traced call's, whose host the profiler slows. None
where the trace holds no `nls.` span."""

from portbench.spans import idle_under, program_spans


def read(rec):
    got = program_spans(rec)
    if got is None:
        return None
    idle = idle_under(*got)
    total = sum(idle.values())
    return idle.get(None, 0.0) / total if total > 0 else 0.0
