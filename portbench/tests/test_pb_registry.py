"""The registry finds every part of every cell by its name, and
BENCHMARK.json keeps to the contract's shape."""
import json
import re

import pytest

from bench import limits, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def one_line(text):
    """A `why`, a `layer`, a `source` or a word of `command`: 1 to 200
    characters on one line, with no tab."""
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and not any(c in text for c in "\n\r\t"))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p.split("/")
               for p in BENCH["paths"])
    assert all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # names are unique, every configuration has a cell, a file of its own
    # and a pair of configuration and traffic appears once
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    configs = [c["name"] for c in BENCH["configs"]]
    for names in (metrics, cells, configs):
        assert len(names) == len(set(names))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/configs/")
    assert NAME.match(entry["name"])
    assert one_line(entry["why"]) and one_line(entry["source"])
    assert entry["source"].startswith(("https://", "http://", "arXiv:"))
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    cfg = registry.load_json(registry.REPO / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_found(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and one_line(wl["why"])
    assert NAME.match(wl["config"]) and NAME.match(wl["traffic"])
    assert wl["chips"] == 1
    registry.config(BENCH, wl)
    traffic = registry.traffic(wl["traffic"])
    assert hasattr(registry.driver(traffic["drive"]), "Cell")
    assert limits.limits_of(wl["name"])
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in registry.metrics_of(BENCH, "end_to_end",
                                                    wl["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of(BENCH, "per_layer", wl["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader_found(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
    assert one_line(m["layer"])
    assert callable(registry.metric_reader(m["name"]))
    assert UNIT.match(m["unit"]) and NAME.match(m["name"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= names
    for w in m["workloads"]:
        assert m["moves"] in [e["name"] for e in registry.metrics_of(
            BENCH, "end_to_end", w)]


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_entry(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"])
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_missing_names_raise():
    with pytest.raises(KeyError):
        registry.find(BENCH["workloads"], "no-such-cell", "workload")
    with pytest.raises(FileNotFoundError):
        registry.traffic("no-such-mix")
