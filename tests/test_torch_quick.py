"""Committed hit ratios reproduced by the port alone, without JAX.

A subset of the k-way ``jnp`` records of benchmarks/baselines/quick.json
(one per trace family; capacity 1024, n=6000, seed 42, batch size 1)
replayed by ``repro_torch.core.simulate.replay`` on the CPU: each hit ratio
must equal its recorded ``value``.  The file is read as data only.
"""
import json
import os

import pytest
import torch

from repro_torch.core import simulate, traces
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

QUICK = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                     "baselines", "quick.json")


def _quick_records():
    with open(QUICK) as f:
        recs = json.load(f)["records"]
    chosen = {"zipf": ("LRU", 4), "zipf_shift": ("LFU", 8),
              "scan_loop": ("HYPERBOLIC", 32), "oltp_mix": ("LRU", 8)}
    return [r for r in recs
            if r["backend"] == "jnp" and r["sample"] == 0
            and r["num_sets"] > 1 and r["admission"] == "none"
            and chosen.get(r["family"]) == (r["policy"], r["ways"])]


@pytest.mark.parametrize("record", _quick_records(), ids=lambda r: r["id"])
def test_quick_baseline_records_reproduced(record):
    """A committed B=1 hit-ratio record, reproduced by the port alone."""
    cfg = KWayConfig(num_sets=record["num_sets"], ways=record["ways"],
                     policy=Policy.parse(record["policy"]))
    (seed,) = record["seeds"]
    tr = traces.generate(record["family"], record["n"], seed=seed)
    got = simulate.replay(simulate.SimConfig(cfg, backend="torch",
                                             device="cpu"), tr)
    assert got == record["value"]


def test_quick_subset_covers_every_family():
    assert sorted(r["family"] for r in _quick_records()) == sorted(
        ["zipf", "zipf_shift", "scan_loop", "oltp_mix"])
