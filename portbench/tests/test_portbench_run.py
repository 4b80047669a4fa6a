"""A run of a cell end to end on the CPU at a tiny size: a cell added as
files is picked up, the result line's keys, and `correct` against faults
planted under the timed path."""

import hashlib
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import bench, cells, check, run
from portbench.trace import Trace
from portbench.traffic import generate

from .conftest import HERE, add_tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _run(root, cell, seed=2 ** 31 + 7, trace=0):
    rec, ok, numbers, attempted, failed = bench.run_cell(
        cell, seed, 0.01, trace, time.perf_counter(), device="cpu",
        root=root, log=lambda msg: None)
    man = cells.manifest(root)
    line = bench.result_line(rec, cells.metric_entries(man, cell, trace), ok,
                             numbers, attempted, failed,
                             {"platform": "cpu", "kind": "cpu", "count": 1},
                             root=root)
    return line, numbers


@pytest.mark.parametrize("tiny", ("tiny2d", "tiny3d", "tinysg2d"))
def test_added_cell_runs_and_is_correct(tiny_root, tiny):
    """A cell added as a configuration, a mix, a workload file and a
    manifest entry (tinysg2d, a real-wave sine-Gordon Gautschi cell: with
    the recipe file of its phenomenon too) runs without any file of the
    harness edited, and the port's CPU path is correct against the
    reference."""
    before = _digests(tiny_root)
    cell = add_tiny(tiny_root, tiny)
    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
    line, numbers = _run(tiny_root, cell)
    assert line["correct"], numbers
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["metrics"]) == {"traj_steps_per_s", "setup_s"}
    assert line["attempted"] >= 2 and line["failed"] == 0


# Recorded on the CPU at commit 4178e57, before the harness took its
# family table: the sha256 of u0, m and c of each mix at B=2 and 32^2
# (seed 2**31 + 21), and the check's numbers of the tiny2d cell at B=2
# (seed 2**31 + 7); the family table changed neither.
BEFORE_INPUTS = (
    "b769edbeb8ff29f179a43ec858539571466abbd4431c9bc839c71da9795e2dfc",
    "37c07dcba2ad5d263499c51b2251e13356f1ccbd8b7912e4b7c762fd0f1a0b04",
    "8b5d3fc86b12b03e8ed6bfeb4f7d4a2800aceb52284d8c0353fdc8db583f9881")
BEFORE_CHECK = {"rel_l2": (2.4299625792710543e-06, 0.0001),
                "start_gap": (0.0, 0), "lanes_not_finite": (0, 0)}


@pytest.mark.parametrize("mix", ("task30", "batch240"))
def test_inputs_are_unchanged(mix):
    """Each mix's inputs are bit for bit those recorded before the family
    table."""
    cfg = cells.config("nlse2d-sweep")
    fields = dict(cells.datagen_fields(cfg), nx=32)
    state, m, c, _ = generate.make_inputs(
        dict(generate.load_mix(mix), batch=2), fields, 2 ** 31 + 21, "cpu")
    assert len(state) == 1
    got = tuple(hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
                for t in (state[0], m, c))
    assert got == BEFORE_INPUTS


def test_check_numbers_are_unchanged(tiny_root):
    """The check's numbers of a tiny NLSE cell are those recorded before
    the family table."""
    _, numbers = _run(tiny_root, add_tiny(tiny_root, "tiny2d", batch=2))
    assert numbers == BEFORE_CHECK


def test_added_metric_is_reported(tiny_root):
    """A per-layer metric added as a reader file and a manifest entry is
    read in the cells it names."""
    cell = add_tiny(tiny_root)
    (tiny_root / "metrics" / "batches_in_window.py").write_text(
        "def read(rec):\n    return len(rec.batches)\n")
    man_path = tiny_root.parent / "BENCHMARK.json"
    man = json.loads(man_path.read_text())
    man["per_layer"].append(dict(
        name="batches_in_window", unit="batches", better="higher",
        source="host_clock", layer="engine readback",
        moves="traj_steps_per_s", workloads=[cell]))
    man_path.write_text(json.dumps(man))
    line, _ = _run(tiny_root, cell, trace=1)
    assert line["metrics"]["batches_in_window"]["value"] >= 1
    assert "pipe_2d_roofline" not in line["metrics"]


@pytest.mark.parametrize("B,k,batches",
                         ((30, 30, 3), (30, 12, 2), (240, 32, 1)))
def test_check_compares_distinct_lanes(B, k, batches):
    """The check's sample: distinct lanes (every batch runs the same
    inputs), the first and the last among them, each from one of the
    window's batches, the same for the same seed."""
    picks = check.sample_lanes(2 ** 31 + 3, B, k, batches)
    lanes = [lane for ls in picks.values() for lane in ls]
    assert len(lanes) == len(set(lanes)) == min(k, B)
    assert {0, B - 1} <= set(lanes) and set(picks) <= set(range(batches))
    assert picks == check.sample_lanes(2 ** 31 + 3, B, k, batches)


def test_result_line_with_a_trace():
    """With a trace the line carries busy_s, window_s and the breakdown,
    before the compared numbers."""
    tr = Trace(window_s=1.0, device=[
        ("void pipe_2d_kernel<2>(float*)", "kernel", 0.1, 0.3),
        ("Memcpy DtoH", "gpu_memcpy", 0.25, 0.4),
        ("void pipe_2d_kernel<2>(float*)", "kernel", 0.6, 0.7)],
        host=[("aten::linalg_eigh", 0.35, 0.65), ("cudaLaunchKernel", 0.7,
                                                  0.95)])
    rec = bench.Record(cell="x", snapshots=3, freq=2,
                       shape=None, window_s=2.0, trace=tr, traced_steps=4,
                       batches=[dict(evolve_s=1.0, readback_s=0.5)])
    entries = [dict(name="device_idle_share", unit="fraction"),
               dict(name="launches_per_step", unit="launches")]
    line = bench.result_line(rec, entries, True, {"rel_l2": (1e-6, 1e-4)},
                             4, 0, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    assert line["device"]["busy_s"] == pytest.approx(0.4)
    assert line["metrics"]["device_idle_share"]["value"] == pytest.approx(0.6)
    assert line["metrics"]["launches_per_step"]["value"] == 0.5
    ops = dict(line["breakdown"]["device_ops"])
    assert ops["pipe_2d_kernel"] == pytest.approx(0.3)
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps["aten::linalg_eigh"] == pytest.approx(0.2)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.3)
    assert gaps["(host between ops)"] == pytest.approx(0.1)


def _unchanged(real):
    def planar_step(*a, **k):
        return lambda state, i: state
    return planar_step


def _half_batch(real):
    def planar_step(*a, **k):
        step = real(*a, **k)

        def half(state, i):
            out = step(state, i).clone()
            out[out.shape[0] // 2:] = state[out.shape[0] // 2:]
            return out
        return half
    return planar_step


FAULTS = {"state unchanged": ("models.problems", "planar_step", _unchanged),
          "half the batch left out": ("models.problems", "planar_step",
                                      _half_batch)}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["answer altered"])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, fault):
    """The timed path broken underneath: the check says not correct.
    (A cell on one chip has no exchange between chips to leave out.)"""
    import importlib
    cell = add_tiny(tiny_root, batch=2)
    limit = cells.workload(cell, tiny_root)["limits"]["rel_l2"]
    if fault == "answer altered":
        evolve = importlib.import_module("nlsolvers_tpu_torch.models.evolve")
        real = evolve.evolve_guarded

        def altered(*a, **k):
            bufs, bad_at, series = real(*a, **k)
            bufs[-1, -1] *= 1.0 + 10 * limit     # the last lane's last
            return bufs, bad_at, series          # snapshot, where made
        monkeypatch.setattr(evolve, "evolve_guarded", altered)
    else:
        mod, name, make = FAULTS[fault]
        target = importlib.import_module(f"nlsolvers_tpu_torch.{mod}")
        monkeypatch.setattr(target, name, make(getattr(target, name)))
    line, numbers = _run(tiny_root, cell)
    assert not line["correct"], numbers
    assert line["check"]["rel_l2"]["value"] > limit


def test_cli_refuses_without_a_card(tmp_path):
    """Without as many CUDA cards as the cell asks for, no result line and
    a nonzero exit."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "nlse2d-sweep.task30", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=HERE.parent, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert run.forbidden_modules(["portbench"]) == []
