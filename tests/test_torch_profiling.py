"""The port's utils/profiling.py on the CPU.

* StepTimer over CPU tensor steps inside annotate(): JAX's summary keys
  (tests/test_datagen.py's StepTimer case run against the JAX package's
  StepTimer beside it), count and rates;
* trace(dir, device="cpu") writes a Chrome trace that names the
  annotation and the step's operators;
* sync on a nested tuple / list / dict returns it unchanged;
* trace(device="cuda") raises where no card is present, before any
  profiling starts, and an exception inside the block still writes the
  trace.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from nlsolvers_tpu.utils import profiling as jprofiling
from nlsolvers_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_step_timer_and_annotate_keys_match_jax():
    want = jprofiling.StepTimer()
    y = jnp.ones((8, 8))
    for _ in range(3):
        with jprofiling.annotate("step"):
            y = y * 1.0001
        want.lap(y)

    t = profiling.StepTimer()
    x = torch.ones((8, 8))
    for _ in range(3):
        with profiling.annotate("step"):
            x = x * 1.0001
        t.lap(x)
    s = t.summary()
    assert sorted(s) == sorted(want.summary())
    assert s["count"] == 3 and s["steps_per_s"] > 0
    assert s["total_s"] == pytest.approx(sum(t.laps))
    assert s["p50_s"] <= s["p95_s"]
    t.lap()
    assert t.summary()["count"] == 4
    t.reset()
    assert t.laps == [] and t.summary() == {}


def _trace_text(logdir):
    files = sorted(logdir.glob("trace_*.json"))
    assert len(files) == 1, files
    text = files[0].read_text()
    json.loads(text)
    return text


def test_trace_cpu_names_the_annotation(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "tb", device="cpu"):
        with profiling.annotate("study-cell"):
            y = torch.mm(x, x)
    text = _trace_text(tmp_path / "tb")
    assert "study-cell" in text and "aten::mm" in text
    assert torch.isfinite(y).all()


def test_trace_writes_on_error(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(tmp_path, device="cpu"):
            with profiling.annotate("failing-block"):
                raise ValueError("inside the block")
    assert "failing-block" in _trace_text(tmp_path)


def test_sync_nested():
    x = torch.ones(3)
    tree = (x, [x * 2, {"a": x, "b": (x, 1.5)}], {"c": None})
    assert profiling.sync(tree) is tree
    assert profiling.sync(x) is x
    assert profiling.sync(None) is None


def test_trace_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(tmp_path / "tb"):
            pass
    with pytest.raises(RuntimeError):
        with profiling.trace(tmp_path / "tb", device="cuda:0"):
            pass
    assert not (tmp_path / "tb").exists()
