"""On the card: a tiny cell with --trace 1 end to end (run on the chip with
`python -m pytest -p no:cacheprovider portbench/tests -m card`)."""

import time

import pytest

from portbench import bench, cells

from .conftest import add_tiny


@pytest.mark.card
@pytest.mark.parametrize("tiny", ("tiny2d", "tiny3d"))
def test_traced_tiny_cell(card, tiny_root, tiny):
    cell = add_tiny(tiny_root, tiny, batch=2)
    rec, ok, numbers, attempted, failed = bench.run_cell(
        cell, 2 ** 31 + 5, 0.01, 1, time.perf_counter(), device="cuda",
        root=tiny_root, log=lambda msg: None)
    man = cells.manifest(tiny_root)
    line = bench.result_line(rec, cells.metric_entries(man, cell, 1), ok,
                             numbers, attempted, failed,
                             {"platform": "gpu", "kind": "card", "count": 1},
                             root=tiny_root)
    assert ok, numbers
    assert rec.trace is not None and rec.syncs is not None
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"] and line["metrics"]
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105, name
