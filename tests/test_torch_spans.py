"""The program's spans (utils/profiling.annotate and spanned) and the
benchmark's readers of them (portbench/spans.py, portbench/metrics/).

Imports no JAX, so the card case also runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py

* a batched 2D SS2 trajectory of the datagen engine, traced on the CPU:
  each span's count a step or a snapshot interval, and their nesting;
* the same trajectory with and without the profiler, bit for bit;
* with no profiler, annotate is the one shared no-op context;
* each of the five span readers on a Trace placed by hand: its exact
  value, and None without the program's spans;
* on the card (skipped without one): one traced call through
  portbench.trace.traced holds the spans on the kernels' clock, each
  wrapper span holds its kernel's launch, and no launch is lost.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from nlsolvers_tpu_torch.pipeline import engine
from nlsolvers_tpu_torch.utils import profiling
from portbench import cells, spans
from portbench.trace import Trace, short_name, traced

torch.set_num_threads(1)

N, B, M, S, FREQ = 32, 2, 6, 3, 2


def _inputs(device, n=N, batch=B):
    g = torch.Generator().manual_seed(7)
    x = torch.linspace(-1.0, 1.0, n)
    r2 = x[None, :] ** 2 + x[:, None] ** 2
    u0 = torch.stack([torch.stack([(1.0 + 0.1 * b) * torch.exp(-4.0 * r2),
                                   0.05 * torch.randn(n, n, generator=g)])
                      for b in range(batch)])
    m = 1.0 + 0.2 * torch.rand(batch, n, n, generator=g)
    c = 1.0 + 0.5 * (x[None, None, :] > 0) * torch.ones(batch, n, n)
    return [t.to(device) for t in (u0, m, c)]


def _traj(device, n=N, m=M):
    return engine.make_nlse_trajectory_fn(
        "cubic", (n, n), 5.0, 1e-3, krylov_m=m, guard=True, device=device)


def _spans_of(logdir):
    (path,) = sorted(logdir.glob("trace_*.json"))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(spans.PREFIX)),
                  key=lambda h: (h[1], -h[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_of_a_traced_batched_trajectory(tmp_path):
    traj = _traj("cpu")
    assert traj.batched
    u0, m, c = _inputs("cpu")
    with profiling.trace(tmp_path, device="cpu"):
        traj(u0, m, c, S, FREQ)
    sp = _spans_of(tmp_path)
    count = {}
    for name, _, _ in sp:
        count[name] = count.get(name, 0) + 1
    steps = (S - 1) * FREQ
    pipes = sum(v for k, v in count.items()
                if k.startswith("nls.launch.pipe_"))
    assert count["nls.step"] == steps and count["nls.eigh"] == steps
    assert count["nls.lanczos"] == count["nls.coefficients"] == steps
    assert count["nls.kick"] == 2 * steps
    assert count["nls.launch.pass1_aniso2d"] == steps
    assert count["nls.launch.combine"] == steps
    assert pipes == count["nls.launch.pipe_aniso2d"] == (M - 1) * steps
    # the first snapshot's check, then one a snapshot interval
    assert count["nls.guard"] == S and count["nls.snapshot"] == S
    assert count["nls.setup"] == 1          # the lane block's operator

    def holders(h):
        return {o[0] for o in sp if o is not h and _inside(h, o)}

    for h in sp:
        if h[0] == "nls.launch.combine":      # after the loop, beside eigh
            assert "nls.lanczos" not in holders(h)
        elif h[0].startswith("nls.launch."):
            assert {"nls.lanczos", "nls.step"} <= holders(h), h
        elif h[0] == "nls.eigh":
            assert "nls.coefficients" in holders(h)
            assert "nls.lanczos" not in holders(h)
        if h[0] not in ("nls.step", "nls.snapshot", "nls.guard",
                        "nls.setup"):
            assert "nls.step" in holders(h), h
        else:
            assert not holders(h), h


def test_trajectory_bits_equal_with_and_without_the_profiler(tmp_path):
    traj = _traj("cpu")
    u0, m, c = _inputs("cpu")
    plain = traj(u0, m, c, S, FREQ)
    with profiling.trace(tmp_path, device="cpu"):
        seen = traj(u0, m, c, S, FREQ)
    assert all(torch.equal(a, b) for a, b in zip(plain, seen))
    assert torch.all(plain[1] == S)


def test_annotate_without_a_profiler_is_the_shared_no_op():
    off = profiling.annotate("nls.step")
    assert off is profiling.annotate("nls.guard")
    with off as entered:
        assert entered is None

    @profiling.spanned("nls.launch.test")
    def wrapper(x):
        return x + 1

    wrapper.launches = 0
    assert wrapper(1) == 2 and wrapper.__wrapped__(1) == 2
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.annotate("nls.step")
        with on:
            wrapper(torch.ones(2))
    assert on is not off
    names = {e.name for e in prof.events()}
    assert {"nls.step", "nls.launch.test"} <= names
    assert profiling.annotate("nls.step") is off


MS = 1e-3


def _hand_trace(with_spans=True):
    """Two steps of 10 ms, each: nls.step [0, 9] holding nls.kick [0, 1]
    (one launch), nls.lanczos [1, 5] (a recurrence launch at 1.1, the
    wrapper span nls.launch.pipe_aniso2d [2, 3] with its cuLaunchKernel
    event, a recurrence launch at 3.5), nls.coefficients [5, 8] holding
    nls.eigh [5.5, 7.5] (two launches), and a launch at 8.2 in the step
    alone; a memcpy call and an aten op, neither a launch. The device is
    idle over [1.5, 4] (in nls.lanczos), [9.2, 9.8] and [18.5, 20] (in no
    span)."""
    host = []
    for o in (0.0, 10.0):
        def at(name, s, e):
            host.append((name, (o + s) * MS, (o + e) * MS))

        at("nls.step", 0, 9)
        at("nls.kick", 0, 1)
        at("cudaLaunchKernel", 0.2, 0.3)
        at("nls.lanczos", 1, 5)
        at("cudaLaunchKernel", 1.1, 1.2)
        at("nls.launch.pipe_aniso2d", 2, 3)
        at("cuLaunchKernel", 2.1, 2.2)
        at("aten::mul", 3.4, 3.7)
        at("cudaLaunchKernel", 3.5, 3.6)
        at("nls.coefficients", 5, 8)
        at("nls.eigh", 5.5, 7.5)
        at("cudaLaunchKernel", 5.6, 5.7)
        at("cudaLaunchKernel", 6.0, 6.1)
        at("cudaMemcpyAsync", 7.0, 7.2)
        at("cudaLaunchKernel", 8.2, 8.3)
    if not with_spans:
        host = [h for h in host if not h[0].startswith(spans.PREFIX)]
    device = [("k", "kernel", s * MS, e * MS)
              for s, e in ((0.0, 1.5), (4.0, 9.2), (9.8, 18.5))]
    return Trace(window_s=20 * MS, device=device, host=host)


@pytest.mark.parametrize("name,want", [
    ("recurrence_ms_per_step", 3.0),            # 4 ms less the 1 ms wrapper
    ("recurrence_launches_per_step", 2.0),
    ("eigh_ms_per_step", 2.0),
    ("eigh_launches_per_step", 2.0),
    ("idle_unattributed_share", 2.1 / 4.6),     # (0.6 + 1.5) of 4.6 ms idle
])
def test_span_reader_on_a_hand_built_trace(name, want):
    read = cells.reader(name).read
    rec = SimpleNamespace(trace=_hand_trace(), traced_steps=2)
    assert read(rec) == pytest.approx(want, rel=1e-9)
    assert read(SimpleNamespace(trace=_hand_trace(False),
                                traced_steps=2)) is None
    assert read(SimpleNamespace(trace=None, traced_steps=0)) is None


def test_span_table_adds_up():
    tr = _hand_trace()
    rows = spans.table(tr, 2)
    assert sum(r["launches"] for r in rows.values()) == 7
    assert rows[None]["launches"] == 0
    assert rows["nls.step"]["launches"] == 1
    assert rows["nls.kick"]["launches"] == 1
    assert rows["nls.launch.pipe_aniso2d"]["launches"] == 1
    idle = sum(e - s for s, e in tr.idle_gaps()) / MS / 2
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(idle)
    assert rows["nls.step"]["self_ms"] == pytest.approx(1.0)
    assert rows["nls.coefficients"]["self_ms"] == pytest.approx(1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_traced_call_on_one_clock(cuda):
    """One traced call of a batched 2D step on the card: the spans sit in
    Trace.host; the call's host launches equal its kernel rows (none lost);
    taken in order (one stream), each kernel row starts after its launch,
    and each wrapper span holds the launch of its own kernel."""
    traj = _traj("cuda", n=64, m=10)
    u0, m, c = _inputs("cuda", n=64, batch=4)
    traj(u0, m, c, 2, 1)
    torch.cuda.synchronize()
    tr = traced(torch, lambda: traj(u0, m, c, 3, 2))
    assert tr is not None
    names = {h[0] for h in spans.spans(tr)}
    assert {"nls.step", "nls.kick", "nls.lanczos", "nls.eigh",
            "nls.coefficients", "nls.snapshot", "nls.guard", "nls.setup",
            "nls.launch.pass1_aniso2d", "nls.launch.pipe_aniso2d",
            "nls.launch.combine"} <= names
    launches = sorted(spans.launches(tr), key=lambda h: h[1])
    kernels = sorted(tr.kernels(), key=lambda d: d[2])
    assert len(launches) == len(kernels)
    mids = [0.5 * (s + e) for _, s, e in launches]
    own = {"nls.launch.pass1_aniso2d": {"pass1_tile_kernel"},
           "nls.launch.pipe_aniso2d": {"pipe_2d_kernel"},
           "nls.launch.combine": {"combine_kernel"},
           "nls.kick": {"kick_bc_kernel"}}
    held = {k: set() for k in own}
    for (_, s, _), k, h in zip(launches, kernels,
                               spans.innermost(spans.spans(tr), mids)):
        assert k[2] >= s, (k, s)
        if h is not None and h[0] in own:
            held[h[0]].add(short_name(k[0]))
    for name, kernel in own.items():
        assert kernel <= held[name], (name, held[name])
    assert 0 < tr.busy_s() <= tr.window_s
