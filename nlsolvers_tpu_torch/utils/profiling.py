"""Profiling / tracing hooks — the observability layer (SURVEY.md section 5).

The port's counterpart of nlsolvers_tpu/utils/profiling.py, on
torch.profiler and torch.cuda:

* `trace(logdir, device="cuda")` — context manager around a
  torch.profiler profile of CPU and CUDA activity, written into logdir as a
  Chrome trace (trace_<pid>_<ns>.json, readable by Perfetto).
  `device="cpu"` records CPU activity only; `device="cuda"` without a card
  raises rather than tracing the CPU alone. torch.profiler drops a trace
  now and then (no kernel events in it): `trace` wraps the caller's code
  and cannot run it again, so a caller that needs the kernels checks the
  file and retries.
* `StepTimer` — per-step walltime accounting with device-synchronized laps
  (the same summary keys as JAX's).
* `annotate(name)` — torch.profiler.record_function, so named regions show
  up inside traces.
* `sync(x)` — torch.cuda.synchronize on each card holding a tensor of x.
"""

import contextlib
import os
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["trace", "StepTimer", "annotate", "sync"]


def _cuda_devices(x, out):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


def sync(x):
    """Block until the work that produces `x` (a tensor, or tuples, lists
    and dicts of them) is done: torch.cuda.synchronize on each CUDA device
    that holds one of its tensors. CPU tensors need nothing."""
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)
    return x


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """torch.profiler trace around a block: `with trace("/tmp/tb"): step()`.
    The Chrome trace lands in logdir when the block ends (after a
    synchronize, so that the block's kernels are in it)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("trace(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to trace CPU activity only")
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
        if on_card:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """Named region visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-step walltimes with device-synchronized laps.

    >>> t = StepTimer()
    >>> for _ in range(n): out = step(out); t.lap(out)
    >>> t.summary()   # {'mean_s', 'p50_s', 'p95_s', 'steps_per_s', ...}
    """

    def __init__(self):
        self.laps = []
        self._t0 = time.perf_counter()

    def reset(self):
        self.laps.clear()
        self._t0 = time.perf_counter()

    def lap(self, result=None):
        if result is not None:
            sync(result)
        now = time.perf_counter()
        self.laps.append(now - self._t0)
        self._t0 = now

    def summary(self):
        if not self.laps:
            return {}
        arr = np.asarray(self.laps)
        return {
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
