"""The program's own spans in a traced call, as the step's per-layer
readers take them (metrics/recurrence_*, metrics/eigh_*,
metrics/idle_unattributed_share).

The port names its spans `nls.<layer>` (nlsolvers_tpu_torch/utils/
profiling.py, `annotate` and `spanned`; PERF.md section 3 lists them). They
record only while a torch.profiler profile runs, as the traced call's does,
and land in its trace as user_annotation events of the calling thread, so
Trace.host holds them beside that thread's CUDA runtime calls, on the
trace's one clock. Spans of one thread nest. A launch is a host event whose
name starts with cudaLaunch or cuLaunch.

Host times read from a traced call include the profiler's own slowing of
the host; counts of launches do not depend on it.

    python3 -m portbench.spans --workload <cell> --seed <n> [--seconds s]

runs the cell once with --trace 1 (the window `--seconds` long, 1 by
default: one batch) and prints one JSON line per span name and one for
"(no span)": its self time, its launches under no deeper span and the
device's idle time whose gap midpoint it holds innermost, each per step of
the traced call; the rows add up to the last line's totals.
"""

import argparse
import json
import sys
import time

__all__ = ["PREFIX", "spans", "launches", "innermost", "self_times",
           "program_spans", "launches_under", "idle_under", "table"]

PREFIX = "nls."
LAUNCH = ("cudaLaunch", "cuLaunch")


def spans(tr):
    """The program's spans (name, start, end) in the trace's host events."""
    return [h for h in tr.host if h[0].startswith(PREFIX)]


def launches(tr):
    """The host's kernel launch events (name, start, end)."""
    return [h for h in tr.host if h[0].startswith(LAUNCH)]


def _nested(sp):
    return sorted(sp, key=lambda h: (h[1], -h[2]))


def innermost(sp, points):
    """For each time of the sorted `points`, the innermost span of `sp`
    (nested spans of one thread) that holds it, or None."""
    sp = _nested(sp)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(sp) and sp[i][1] <= t:
            while stack and stack[-1][2] < sp[i][1]:
                stack.pop()
            stack.append(sp[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def self_times(sp):
    """[(name, seconds)]: each span's length less its direct children's."""
    sp = _nested(sp)
    own = [e - s for _, s, e in sp]
    stack = []
    for k, (_, s, e) in enumerate(sp):
        while stack and sp[stack[-1]][2] <= s:
            stack.pop()
        if stack:
            own[stack[-1]] -= e - s
        stack.append(k)
    return [(h[0], t) for h, t in zip(sp, own)]


def _under(sp, events):
    """{span name or None: [(start, end)]} of `events`, each under the
    innermost span of `sp` that holds its midpoint."""
    events = sorted(events, key=lambda ev: ev[-2] + ev[-1])
    out = {}
    for ev, h in zip(events, innermost(
            sp, [0.5 * (ev[-2] + ev[-1]) for ev in events])):
        out.setdefault(None if h is None else h[0], []).append(ev[-2:])
    return out


def program_spans(rec):
    """(trace, spans) of a run's traced call, or None where the run was not
    traced or its trace holds no span of the program (a program without
    spans reads None, not 0)."""
    tr = rec.trace
    if tr is None or not rec.traced_steps:
        return None
    sp = spans(tr)
    return (tr, sp) if sp else None


def launches_under(tr, sp, name):
    """Launches whose innermost span is called `name`."""
    return len(_under(sp, launches(tr)).get(name, ()))


def idle_under(tr, sp):
    """{span name or None: idle seconds} of the trace's idle gaps, each
    named by the innermost span that holds its midpoint."""
    return {k: sum(e - s for s, e in v)
            for k, v in _under(sp, tr.idle_gaps()).items()}


def table(tr, steps):
    """{span name or None: {self_ms, launches, idle_ms}} per step; None
    holds the launches and idle time under no span."""
    sp = spans(tr)
    rows = {}

    def row(k):
        return rows.setdefault(k, dict(self_ms=0.0, launches=0.0,
                                       idle_ms=0.0))

    for name, t in self_times(sp):
        row(name)["self_ms"] += 1e3 * t / steps
    for name, evs in _under(sp, launches(tr)).items():
        row(name)["launches"] += len(evs) / steps
    for name, t in idle_under(tr, sp).items():
        row(name)["idle_ms"] += 1e3 * t / steps
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from portbench import bench

    rec, correct, *_ = bench.run_cell(
        args.workload, args.seed, args.seconds, 1, time.perf_counter(),
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    tr, n = rec.trace, rec.traced_steps
    for name, r in sorted(table(tr, n).items(),
                          key=lambda kv: -kv[1]["self_ms"]):
        print(json.dumps(dict(span=name or "(no span)", **r)))
    print(json.dumps(dict(
        total=True, cell=args.workload, correct=correct, steps=n,
        window_ms=1e3 * tr.window_s / n, busy_ms=1e3 * tr.busy_s() / n,
        idle_ms=1e3 * sum(e - s for s, e in tr.idle_gaps()) / n,
        launches=len(launches(tr)) / n, kernels=len(tr.kernels()) / n,
        step_ms=1e3 * rec.step_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
