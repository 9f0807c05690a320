"""Finds every part of a cell by its name in ``BENCHMARK.json``:

* a configuration: the JSON file its entry names (``portbench/configs/``);
* a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``drive``
  names the general driver that runs it, ``portbench/bench/drive_<drive>.py``;
* a per-layer metric: ``portbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the metric's value or None.

A later cell adds files and entries; nothing here changes for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config(bench: dict, workload: dict) -> dict:
    entry = find(bench["configs"], workload["config"], "configuration")
    return load_json(REPO / entry["file"])


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def driver(drive: str):
    return importlib.import_module(f"bench.drive_{drive}")


def metric_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload``
    reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]
