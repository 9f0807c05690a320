"""The port's sweep runner (``repro_torch/eval/runner.py``) against the
reference's (``repro/eval/runner.py``) run live on the same small specs:
the stacked ``torch`` group against the vmapped ``jnp`` scan, and the
``cuda`` points (kernel 3's plain version on the CPU) against the
``pallas`` group, record for record after ``port_id``; the skipped lists;
seed-stable ids; and one capture (on the CPU: one group replay) per cache
shape group."""
import json
import os

import pytest
import torch

from repro.core.policies import Policy as RefPolicy
from repro.eval import runner as ref_runner
from repro_torch.core import admission, traces
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.core.simulate import SimConfig, replay
from repro_torch.eval import runner
from repro_torch.eval.artifacts import port_id
from repro_torch.eval.runner import HitRatioSpec, SweepPoint, assoc_shape

torch.set_num_threads(1)

ALL = ("LRU", "LFU", "FIFO", "RANDOM", "HYPERBOLIC")
QUICK = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                     "baselines", "quick.json")


def _specs(backends, ref_backends, admissions, families=("zipf",),
           assoc=("k4", "sampled4", "full"), n=400, capacity=64, seeds=(5,)):
    port = HitRatioSpec(families=families,
                        policies=tuple(Policy[p] for p in ALL), assoc=assoc,
                        backends=backends, admissions=admissions,
                        capacity=capacity, n=n, seeds=seeds)
    ref = ref_runner.HitRatioSpec(
        families=families, policies=tuple(RefPolicy[p] for p in ALL),
        assoc=assoc, backends=ref_backends, admissions=admissions,
        capacity=capacity, n=n, seeds=seeds)
    return port, ref


def _assert_records_equal(port_recs, ref_recs):
    ref_by_id = {port_id(r["id"]): r for r in ref_recs}
    assert sorted(ref_by_id) == sorted(r["id"] for r in port_recs)
    for rec in port_recs:
        ref = dict(ref_by_id[rec["id"]])
        ref["id"], ref["backend"] = port_id(ref["id"]), port_id(ref["backend"])
        assert rec == ref, rec["id"]


def test_assoc_shape():
    assert assoc_shape("k8", 1024) == (128, 8, 0)
    assert assoc_shape("full", 1024) == (1, 1024, 0)
    assert assoc_shape("sampled8", 1024) == (1, 1024, 8)
    for bad in ("k3", "bogus"):
        with pytest.raises(ValueError):
            assoc_shape(bad, 1024)
        with pytest.raises(ValueError):
            ref_runner.assoc_shape(bad, 1024)
    for a in ("k4", "k8", "k32", "sampled4", "sampled16", "full"):
        assert assoc_shape(a, 1024) == ref_runner.assoc_shape(a, 1024)


@pytest.mark.parametrize("adm", ["none", "tinylfu"])
def test_torch_group_equals_reference_jnp(adm):
    """All 5 policies in one group per shape; k-way, sampled and full."""
    port, ref = _specs(("torch",), ("jnp",), (adm,))
    recs, skipped = runner.run_hit_ratio_sweep(port, device="cpu")
    ref_recs, ref_skipped = ref_runner.run_hit_ratio_sweep(ref)
    assert not skipped and not ref_skipped and len(recs) == 15
    _assert_records_equal(recs, ref_recs)


@pytest.mark.parametrize("adm", ["none", "tinylfu"])
def test_cuda_points_equal_reference_pallas(adm):
    """``cuda`` points (kernel 3's plain version here) against the pallas
    group's per-request kernel-1 probes; sampled shapes are skipped by
    both."""
    port, ref = _specs(("cuda",), ("pallas",), (adm,))
    recs, skipped = runner.run_hit_ratio_sweep(port, device="cpu")
    ref_recs, ref_skipped = ref_runner.run_hit_ratio_sweep(ref)
    assert len(recs) == 10
    assert skipped == [port_id(s) for s in ref_skipped]
    _assert_records_equal(recs, ref_recs)


@pytest.mark.parametrize("policy,assoc", [("LRU", "k4"),
                                          ("RANDOM", "sampled4"),
                                          ("HYPERBOLIC", "full")])
def test_group_equals_simulate_replay(policy, assoc):
    """The stacked group, point by point, against the port's single-config
    B=1 replay (``simulate.replay`` on the torch backend), with TinyLFU."""
    spec = HitRatioSpec(families=("oltp_mix",),
                        policies=(Policy.LFU, Policy[policy]), assoc=(assoc,),
                        admissions=("tinylfu",), capacity=64, n=250,
                        seeds=(8,))
    recs, _ = runner.run_hit_ratio_sweep(spec, device="cpu")
    for rec in recs:
        cfg = KWayConfig(num_sets=rec["num_sets"], ways=rec["ways"],
                         sample=rec["sample"], policy=Policy[rec["policy"]])
        tr = traces.generate(rec["family"], rec["n"], seed=8)
        sim = SimConfig(cfg, admission.for_capacity(64), backend="torch",
                        device="cpu")
        assert rec["value"] == replay(sim, tr), rec["id"]


def test_quick_grid_skipped_equals_reference():
    """The quick grid's 24 skipped entries, modulo port_id: the committed
    baseline's and the reference's spec's."""
    with open(QUICK) as f:
        committed = json.load(f)["skipped"]
    assert len(committed) == 24
    kw = dict(families=("zipf", "zipf_shift", "scan_loop", "oltp_mix"),
              assoc=("k4", "k8", "k32", "sampled8", "full"), capacity=1024,
              n=6000, seeds=(42,))
    _, skipped = HitRatioSpec(
        policies=(Policy.LRU, Policy.LFU, Policy.HYPERBOLIC),
        backends=("torch", "cuda"), **kw).expand()
    _, ref_skipped = ref_runner.HitRatioSpec(
        policies=(RefPolicy.LRU, RefPolicy.LFU, RefPolicy.HYPERBOLIC),
        backends=("jnp", "pallas"), **kw).expand()
    assert skipped == [port_id(s) for s in committed]
    assert skipped == [port_id(s) for s in ref_skipped]


def test_skips_are_loud():
    spec = HitRatioSpec(
        families=("zipf",), policies=(Policy.LRU,),
        assoc=("k4", "sampled8", "full"), backends=("torch", "cuda", "ref"),
        capacity=256, n=100, seeds=(1,))
    points, skipped = spec.expand()
    assert "zipf/LRU/k4/cuda/none" in {p.record_id for p in points}
    assert any("sampled8/cuda" in s for s in skipped)
    assert any("full/cuda" in s for s in skipped)
    assert sum("/ref:" in s for s in skipped) == 3   # oracle never sweeps


def test_record_ids_are_seed_stable():
    p1 = SweepPoint(family="zipf", policy=Policy.LRU, assoc="k8",
                    capacity=1024, seed=1)
    p2 = SweepPoint(family="zipf", policy=Policy.LRU, assoc="k8",
                    capacity=1024, seed=2)
    r1 = ref_runner.SweepPoint(family="zipf", policy=RefPolicy.LRU,
                               assoc="k8", capacity=1024, seed=3)
    assert p1.record_id == p2.record_id == "zipf/LRU/k8/torch/none"
    assert p1.record_id == port_id(r1.record_id)


def test_one_capture_per_shape_group():
    """2 families x 3 policies x 2 associativities x 2 seeds = 24 replays
    in 2 cache shapes: 2 group replays (on the card, 2 CUDA graphs)."""
    runner.reset_capture_counts()
    spec = HitRatioSpec(
        families=("zipf", "oltp_mix"),
        policies=(Policy.LRU, Policy.LFU, Policy.FIFO), assoc=("k4", "k8"),
        capacity=256, n=100, seeds=(1, 2))
    points, _ = spec.expand()
    assert len(points) == 24
    records, _ = runner.run_hit_ratio_sweep(spec, device="cpu")
    assert len(records) == 12
    counts = runner.capture_counts()
    assert sum(counts.values()) == 2, counts
    assert all(k[0] == "torch" for k in counts)
    runner.run_hit_ratio_sweep(spec, device="cpu")   # within the bound again
    assert sum(runner.capture_counts().values()) == 4
    runner.reset_capture_counts()


def test_sweep_asserts_capture_economy(monkeypatch):
    """``run_hit_ratio_sweep`` fails when a group captures more than once."""
    real = runner._replay_group_torch

    def twice(*args):
        real(*args)
        return real(*args)

    monkeypatch.setattr(runner, "_replay_group_torch", twice)
    spec = HitRatioSpec(families=("zipf",), policies=(Policy.LRU,),
                        assoc=("k4",), capacity=64, n=50, seeds=(3,))
    with pytest.raises(AssertionError, match="shape groups"):
        runner.run_hit_ratio_sweep(spec, device="cpu")


def test_ref_is_not_a_substrate():
    spec = HitRatioSpec(families=("zipf",), policies=(Policy.LRU,),
                        assoc=("k4",), backends=("ref",), capacity=64, n=50)
    points, skipped = spec.expand()
    assert not points and len(skipped) == 1 and "oracle" in skipped[0]
