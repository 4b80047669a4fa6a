"""BENCHMARK.json and the files it names: every name loads, and the
manifest keeps to the benchmark's rules: names, units, bounds, sources."""

import json
import re

import pytest

from portbench import cells
from portbench.traffic import generate

from .conftest import HERE

MAN = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_manifest_keys():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    """The cell's workload, configuration and mix load by name, and the
    workload file names the manifest's configuration and mix."""
    wl = cells.workload(w["name"])
    assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
    cfg = cells.config(w["config"])
    mix = generate.load_mix(w["traffic"])
    assert cfg["phenomenon"] in mix["ic"]
    assert cfg["anisotropy_type"] in mix["c"] and cfg["m_type"] in mix["m"]
    assert set(wl["limits"]) == {"rel_l2", "start_gap", "lanes_not_finite"}
    assert w["chips"] == 1 and NAME.match(w["name"]) and len(w["why"]) <= 200


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    """A configuration's file lies under paths, names itself, and carries
    the manifest's source and `reduced`."""
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = cells.config(c["name"])
    assert cfg["name"] == c["name"]
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("e", METRICS, ids=lambda e: e["name"])
def test_metric_entry(e):
    """Each metric has a reader of its own, a unit and a source the
    benchmark takes, and a per-layer metric moves an end-to-end one."""
    assert NAME.match(e["name"]) and UNIT.match(e["unit"])
    assert e["better"] in ("lower", "higher")
    assert callable(cells.reader(e["name"]).read)
    if e in MAN["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    else:
        assert e["moves"] in {x["name"] for x in MAN["end_to_end"]}
        assert e["layer"] and "\n" not in e["layer"]
    if "_roofline" in e["name"]:
        assert e["unit"] == "%"
    for cell in e.get("workloads", []):
        assert e in cells.metric_entries(MAN, cell, e in MAN["per_layer"])


def test_every_cell_reports_setup_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {e["name"] for e in cells.metric_entries(MAN, w["name"], 0)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metric_entries(MAN, w["name"], 1)


def test_check_fits_the_day():
    """24 cells at this run length fit the full check's 43200 s."""
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
