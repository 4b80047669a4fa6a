"""One traced call of the timed path, reduced to what the metrics read.

torch.profiler traces the call with the CPU and CUDA activities; the call
and its closing synchronize sit inside one record_function span, whose
length on the trace's clock is the traced window. The chrome trace is
written under TMPDIR, read and deleted. The profiler drops a trace now and
then, so a trace with no kernel in it is taken again (up to five times),
as chip_smoke.profiled does.
"""

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

__all__ = ["Trace", "traced", "count_syncs"]

SPAN = "portbench.traced_call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    """The traced window: its length, the device's operations in it and the
    host's spans, times in seconds from the window's start."""
    window_s: float
    device: list = field(default_factory=list)   # (name, cat, start, end)
    host: list = field(default_factory=list)     # (name, start, end)

    def kernels(self):
        return [d for d in self.device if d[1] == "kernel"]

    def busy_intervals(self):
        """The union of the device's operation intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        spans = sorted((max(0.0, s), min(self.window_s, e))
                       for _, _, s, e in self.device)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self):
        """(start, end) of every stretch of the window with nothing on the
        device."""
        gaps, t = [], 0.0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def gaps_by_host_op(self):
        """{host span: idle seconds}: each idle gap named by the innermost
        host span (on the calling thread, whose spans nest) that holds its
        midpoint."""
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        out, stack, i = {}, [], 0
        for s, e in self.idle_gaps():
            t = 0.5 * (s + e)
            while i < len(host) and host[i][1] <= t:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            name = stack[-1][0] if stack else "(host between ops)"
            out[name] = out.get(name, 0.0) + (e - s)
        return out


def short_name(name):
    """A kernel name without its return type, anonymous namespaces,
    template arguments and parameters: "void (anonymous
    namespace)::pipe_2d_kernel<2, 32>(float const*)" -> "pipe_2d_kernel"."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0].strip()
    return head.split()[-1] if head else name


def _parse(path):
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    span = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        return None
    t0, tid = float(span[0]["ts"]), span[0].get("tid")
    win = float(span[0]["dur"]) * 1e-6
    tr = Trace(window_s=win)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s = (float(e["ts"]) - t0) * 1e-6
        end = s + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            tr.device.append((e.get("name", ""), cat, s, end))
        elif (cat in HOST_CATS and e.get("name") != SPAN
              and e.get("tid") == tid):
            tr.host.append((e.get("name", ""), s, end))
    return tr if tr.kernels() else None


def traced(torch, fn, tries=5):
    """Trace of fn() and a synchronize, or None when every try comes back
    without a kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(SPAN):
                    fn()
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            tr = _parse(path)
            if tr is not None:
                return tr
            time.sleep(0.2)
        return None
    finally:
        os.unlink(path)


def count_syncs(torch, fn):
    """Host syncs that fn() makes, by torch.cuda's sync debug mode (as
    chip_smoke.host_syncs counts them)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)
