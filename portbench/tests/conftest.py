"""Fixtures of the benchmark's own tests (run from the repository root):

    python -m pytest -p no:cacheprovider portbench/tests

Tests marked `card` need a CUDA card; the `card` fixture skips them here,
deciding inside the test, never at import. `tiny_root` is a copy of the
harness with tiny cells added as files, the way a later change adds a cell.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]          # portbench/
TINY = {"tiny2d": dict(base="nlse2d-sweep", nx=24, T=0.024, nt=40,
                       snapshots=5),
        "tiny3d": dict(base="nlse2d-sweep", dim=3, nx=12, T=0.012, nt=20,
                       snapshots=5, krylov_m=10,
                       phenomenon="multi_soliton_state")}
# the cell whose metrics and limits a tiny cell takes
REAL = "nlse2d-sweep.task30"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def add_tiny(root, cell="tiny2d", batch=2, limits=None):
    """Add a tiny configuration, mix and cell to the harness copy at
    `root`, and the cell to its manifest, reporting what the cell REAL
    reports, with its limits. Returns the cell's name."""
    spec = dict(TINY[cell])
    base = json.loads((root / "configs" / f"{spec.pop('base')}.json")
                      .read_text())
    base.update(name=cell, **spec)
    (root / "configs" / f"{cell}.json").write_text(json.dumps(base))
    mix = json.loads((root / "traffic" / "task30.json").read_text())
    mix["batch"] = batch
    (root / "traffic" / f"tiny{batch}.json").write_text(json.dumps(mix))
    real_limits = json.loads((root / "workloads" / f"{REAL}.json")
                             .read_text())["limits"]
    name = f"{cell}.b{batch}"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(dict(
        config=cell, traffic=f"tiny{batch}", why="tiny", check_lanes=batch,
        check_block=batch, limits=limits or real_limits)))
    man_path = root.parent / "BENCHMARK.json"
    man = json.loads(man_path.read_text())
    man["configs"].append(dict(name=cell, source="test", reduced=[],
                               file=f"portbench/configs/{cell}.json",
                               why="tiny"))
    man["workloads"].append(dict(name=name, config=cell,
                                 traffic=f"tiny{batch}", chips=1,
                                 why="tiny"))
    for e in man["end_to_end"] + man["per_layer"]:
        if REAL in e.get("workloads", ()):
            e["workloads"].append(name)
    man_path.write_text(json.dumps(man))
    return name


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of portbench/ and BENCHMARK.json under tmp_path; returns the
    copy's portbench/."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root
