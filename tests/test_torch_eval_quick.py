"""All 60 ``torch`` records of the committed quick grid
(``benchmarks/baselines/quick.json``: 4 families x 3 policies x 5
associativities, capacity 1024, n 6000, seed 42) reproduced by the port's
stacked sweep on the CPU, one test per cache-shape group, each value
exactly the committed one (the file's tol is 0.01).  Its 36 ``cuda``
records (kernel 3 per point) are reproduced on the card by
``chip_smoke.py``'s ``phase_eval``."""
import json
import os

import pytest
import torch

from repro_torch.core.policies import Policy
from repro_torch.eval import runner
from repro_torch.eval.artifacts import port_id
from repro_torch.eval.runner import HitRatioSpec

torch.set_num_threads(1)

QUICK = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                     "baselines", "quick.json")


def _committed():
    with open(QUICK) as f:
        art = json.load(f)
    return art["spec"], {port_id(r["id"]): r for r in art["records"]
                         if r["backend"] == "jnp"}


@pytest.mark.parametrize("assoc", ["k4", "k8", "k32", "sampled8", "full"])
def test_quick_grid_torch_group(assoc):
    spec_d, committed = _committed()
    spec = HitRatioSpec(
        families=tuple(spec_d["families"]),
        policies=tuple(Policy[p] for p in spec_d["policies"]),
        assoc=(assoc,), backends=("torch",), capacity=spec_d["capacity"],
        n=spec_d["n"], seeds=tuple(spec_d["seeds"]))
    runner.reset_capture_counts()
    records, skipped = runner.run_hit_ratio_sweep(spec, device="cpu")
    assert not skipped and len(records) == 12
    assert sum(runner.capture_counts().values()) == 1
    for rec in records:
        want = committed[rec["id"]]
        assert rec["value"] == want["value"], rec["id"]
        assert rec["per_seed"] == want["per_seed"], rec["id"]


def test_quick_grid_has_60_torch_records():
    _, committed = _committed()
    assert len(committed) == 60
    assert {r["assoc"] for r in committed.values()} == {
        "k4", "k8", "k32", "sampled8", "full"}
