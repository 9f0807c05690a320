"""The port's figures (``repro_torch/eval/figures.py``) on the CPU.

Each committed baseline that the CPU can reach in seconds is reproduced
by the port's figure, called with the arguments its ``spec`` records,
through the port's ``compare_to_baseline`` (``port_id`` joins the
reference's ids): ``robustness(quick=True, ttl=True)`` (28 comparable
records), ``throughput_resident(quick=True)`` (8), ``showdown(quick=
True)`` (18 of 24: the 6 ``cachetools`` records need a library that is
not installed), ``serving_engine(quick=True)`` (2, with the port's own
weights), ``hierarchy(quick=True)`` (6) and ``throughput_vs_shards(
quick=True)`` (8).  The timers repeat a call once here (``fast_timers``):
the CPU's timings are not what these tests hold.  The quick grid of
``quick.json`` is in ``tests/test_torch_eval_quick.py`` (torch rows) and
on the card (all 96 records, ``chip_smoke.py``).
"""
import functools
import os

import pytest
import torch

from repro_torch.eval import artifacts, figures
from repro_torch.eval.artifacts import port_id

torch.set_num_threads(1)

BASELINES = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "baselines")
CACHETOOLS_IDS = {f"showdown-hr/{f}/{p}/cachetools"
                  for f in ("zipf", "oltp_mix", "lirs_two_pools")
                  for p in ("lru", "lfu")}


@pytest.fixture
def fast_timers(monkeypatch):
    """Every timer of the figures runs its call once, with no warm-up."""
    from repro_torch.eval import timing
    for name in ("time_jitted", "time_jitted_percentiles",
                 "time_chained_percentiles", "time_replay_percentiles"):
        fn = getattr(timing, name)
        monkeypatch.setattr(figures, name, functools.partial(
            _once, fn))
    monkeypatch.setattr(figures, "time_host",
                        lambda fn, *a, iters=3: timing.time_host(fn, *a,
                                                                 iters=1))


def _once(fn, *args, iters=None, warmup=None):
    return fn(*args, iters=1, warmup=0)


def _gate(name, baseline, **kw):
    fn, figure = figures.FIGURES[name]
    spec, records, skipped = fn(quick=True, device="cpu", **kw)
    art = artifacts.make_artifact(figure, spec, records, skipped,
                                  device="cpu")
    base = artifacts.load_artifact(os.path.join(BASELINES, baseline))
    return art, base, artifacts.compare_to_baseline(art, base)


def _comparable(base):
    return [r for r in base["records"] if r.get("comparable")]


@pytest.mark.parametrize("name,baseline,kw,n_cmp", [
    ("robustness", "BENCH_robustness_quick.json", {"ttl": True}, 28),
    ("throughput_resident", "BENCH_throughput_resident_quick.json",
     {"backends": ("torch", "cuda")}, 8),
    ("serving_engine", "BENCH_serving_engine_quick.json", {}, 2),
    ("hierarchy", "BENCH_throughput_hierarchy_quick.json", {}, 6),
    ("throughput_shards", "BENCH_throughput_vs_shards_quick.json",
     {"shards": (1, 2, 4, 8)}, 8),
])
def test_baseline_reproduced(fast_timers, name, baseline, kw, n_cmp):
    art, base, breaches = _gate(name, baseline, **kw)
    assert len(_comparable(base)) == n_cmp
    assert breaches == []
    assert art["env"]["device"] == "cpu"
    assert art["env"]["card_power_limit"] is None


def test_showdown_baseline_reproduced_but_cachetools(fast_timers):
    art, base, breaches = _gate("showdown", "BENCH_showdown_quick.json")
    assert len(_comparable(base)) == 24
    assert sorted(breaches) == sorted(
        f"{rid}: present in baseline, missing from run"
        for rid in CACHETOOLS_IDS)
    assert len([s for s in art["skipped"] if "cachetools" in s]) == 6 * 4 + 6
    ours = {r["id"] for r in art["records"]}
    assert "showdown-hr/zipf/lru/cuda-resident" in ours
    assert "showdown/zipf/striped-lfu/threads8" in ours


def test_robustness_ladder_lands_on_cuda_scan(fast_timers):
    from repro_torch.robust.ladder import RUNGS
    _, records, _ = figures.robustness(quick=True, device="cpu")
    rung = {r["id"]: r for r in records}["robust-ladder/smem-breach/rung"]
    assert rung["rung"] == "cuda-scan" == RUNGS[2]
    assert rung["value"] == 2.0


@pytest.mark.parametrize("name,kw", [
    ("hit_ratio", {"backends": ("torch", "cuda")}),
    ("sampled_vs_limited", {}),
    ("admission", {}),
])
def test_hit_ratio_figures_tiny(monkeypatch, tmp_path, name, kw):
    """The hit-ratio figures at a tiny size: every record id of the quick
    grid, and a loadable artifact."""
    monkeypatch.setattr(figures, "QUICK_N", 64)
    fn, figure = figures.FIGURES[name]
    spec, records, skipped = fn(quick=True, device="cpu", **kw)
    path = artifacts.write_artifact(
        str(tmp_path / f"BENCH_{figure}.json"),
        artifacts.make_artifact(figure, spec, records, skipped,
                                device="cpu"))
    art = artifacts.load_artifact(path)
    assert art["figure"] == figure and art["records"] == records
    assert all(0.0 <= r["value"] <= 1.0 for r in records)
    if name == "hit_ratio":
        base = artifacts.load_artifact(os.path.join(BASELINES, "quick.json"))
        assert sorted(r["id"] for r in records) == sorted(
            port_id(r["id"]) for r in _comparable(base))
        assert skipped == [port_id(s) for s in base["skipped"]]


@pytest.mark.parametrize("name,kw", [
    ("throughput", {"backends": ("torch", "cuda", "ref"), "shards": (1, 2)}),
    ("synthetic_mix", {}),
    ("serving", {"requests": 3}),
])
def test_timing_figures_run(fast_timers, tmp_path, name, kw):
    fn, figure = figures.FIGURES[name]
    spec, records, skipped = fn(quick=True, device="cpu", **kw)
    path = artifacts.write_artifact(
        str(tmp_path / f"BENCH_{figure}.json"),
        artifacts.make_artifact(figure, spec, records, skipped,
                                device="cpu"))
    assert artifacts.load_artifact(path)["records"] == records
    assert records and all(r["value"] >= 0 for r in records)
    if name == "throughput":
        ids = {r["id"] for r in records}
        for rid in ("backend-cuda-fused/batch64", "replay-resident-cuda/"
                    "batch256", "backend-ref-twophase/batch64",
                    "sharded-2shard/batch256", "kway-aos/batch256"):
            assert rid in ids
        assert skipped == [f"backend-torch-fused-donated/batch{b}: the port "
                           "has no donating access (its functions return "
                           "new tensors)" for b in (64, 256)]


def test_fused_baseline_ids_covered(fast_timers):
    """``BENCH_throughput_fused_quick.json`` has no comparable record; its
    rows map by ``port_id`` onto the port's rows, the donated ones onto
    ``skipped``."""
    spec, records, skipped = figures.throughput_vs_batch(
        quick=True, backends=("torch", "cuda"), shards=(1,), device="cpu")
    base = artifacts.load_artifact(
        os.path.join(BASELINES, "BENCH_throughput_fused_quick.json"))
    assert not _comparable(base)
    ours = {r["id"] for r in records}
    donated = {s.split(":")[0] for s in skipped}
    for r in base["records"]:
        assert port_id(r["id"]) in ours | donated, r["id"]
