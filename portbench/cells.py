"""What the harness finds by name: cells, configurations, traffic mixes,
metric readers and the metrics each cell reports.

  BENCHMARK.json                  the manifest: cells, metrics, bounds
  portbench/workloads/<cell>.json  a cell: its configuration, traffic mix,
                                  the lanes the check compares and its limits
  portbench/configs/<config>.json  the DatagenConfig fields of a deployment,
                                  its source, `reduced` and `assumed`
  portbench/traffic/<mix>.json     a traffic mix (traffic/generate.py)
  portbench/metrics/<metric>.py    a metric's reader: read(record) -> a
                                  number, or None where it finds nothing

A cell, configuration, mix or per-layer metric is added by adding its file
and its entry in BENCHMARK.json; no file of the harness changes.
"""

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["HERE", "manifest", "workload", "config", "reader",
           "metric_entries", "datagen_fields"]

HERE = Path(__file__).resolve().parent

# the keys of a configuration file that are not DatagenConfig fields
NOT_FIELDS = ("name", "source", "reduced", "assumed", "reference")


def _load(path, what):
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {path.stem!r} ({path})")
    return json.loads(path.read_text())


def manifest(root=HERE):
    """BENCHMARK.json at the root of the checkout that holds `root`."""
    return _load(Path(root).parent / "BENCHMARK.json", "manifest")


def workload(name, root=HERE):
    return _load(Path(root) / "workloads" / f"{name}.json", "workload")


def config(name, root=HERE):
    return _load(Path(root) / "configs" / f"{name}.json", "configuration")


def datagen_fields(cfg):
    """The DatagenConfig fields of a configuration file."""
    return {k: v for k, v in cfg.items() if k not in NOT_FIELDS}


def reader(name, root=HERE):
    """The reader module of metric `name`: portbench/metrics/<name>.py."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_entries(man, cell, trace):
    """The manifest's entries that `cell` reports: its end-to-end metrics
    (trace off), or its per-layer ones (trace on). An entry with a
    `workloads` key holds for those cells; a per-layer entry without one
    for every cell that reports the end-to-end metric it moves."""
    e2e = [e for e in man["end_to_end"]
           if cell in e.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {e["name"] for e in e2e}
    return [e for e in man["per_layer"]
            if (cell in e["workloads"] if "workloads" in e
                else e["moves"] in names)]
