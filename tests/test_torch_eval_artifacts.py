"""The port's artifacts (``repro_torch/eval/artifacts.py``) against the
reference's: the same schema, round trip, refusal of foreign and stale
files, the three compare rules (held to ``repro.eval.artifacts.
compare_to_baseline`` on the same artifact pairs), ``port_id``, and the
CLI's exit codes with a stub figure."""
import json
import os

import pytest

from repro.eval import artifacts as ref_artifacts
from repro_torch.eval import artifacts
from repro_torch.eval.artifacts import port_id

BASELINES = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "baselines")
BASELINE_FILES = sorted(f for f in os.listdir(BASELINES)
                        if f.endswith(".json"))


def _records(values, timing=None, tol=None):
    recs = []
    for rid, v in values.items():
        r = {"id": rid, "metric": "hit_ratio", "value": v,
             "comparable": True}
        if tol is not None:
            r["tol"] = tol
        recs.append(r)
    for rid, v in (timing or {}).items():
        recs.append({"id": rid, "metric": "mops_per_s", "value": v,
                     "comparable": False})
    return recs


def _pair(base_vals, fresh_vals, figure="fig", fresh_figure="fig", **kw):
    base = artifacts.make_artifact(figure, {"quick": True},
                                   _records(base_vals, **kw), device="cpu")
    fresh = artifacts.make_artifact(fresh_figure, {"quick": True},
                                    _records(fresh_vals, **kw), device="cpu")
    return fresh, base


def test_roundtrip(tmp_path):
    art = artifacts.make_artifact("hit_ratio_vs_associativity", {"n": 5},
                                  _records({"a/b": 0.5}), ["x: skipped"],
                                  device="cpu")
    path = artifacts.write_artifact(str(tmp_path / "sub" / "a.json"), art)
    got = artifacts.load_artifact(path)
    assert got == art
    assert got["kind"] == "repro_torch.eval.artifact"
    assert got["schema_version"] == ref_artifacts.SCHEMA_VERSION == 1
    env = got["env"]
    for key in ("python", "torch", "cuda", "numpy", "platform", "device",
                "device_name", "device_count", "card_power_limit", "timing"):
        assert key in env
    assert env["device"] == "cpu" and env["card_power_limit"] is None
    assert set(art) == set(ref_artifacts.make_artifact("f", {}, []))


def test_load_rejects_foreign_and_stale(tmp_path):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"kind": "other", "schema_version": 1}))
    with pytest.raises(ValueError, match="not a"):
        artifacts.load_artifact(str(p))
    p.write_text(json.dumps({"kind": artifacts.KIND, "schema_version": 0}))
    with pytest.raises(ValueError, match="schema_version"):
        artifacts.load_artifact(str(p))
    p.write_text(json.dumps({"kind": artifacts.REF_KIND,
                             "schema_version": 2}))
    with pytest.raises(ValueError, match="schema_version"):
        artifacts.load_artifact(str(p))


@pytest.mark.parametrize("name", BASELINE_FILES)
def test_committed_baselines_load(name):
    art = artifacts.load_artifact(os.path.join(BASELINES, name))
    assert art["kind"] == artifacts.REF_KIND


CASES = {
    "identical": (({"a": 0.5, "b": 0.7}, {"a": 0.5, "b": 0.7}), {}),
    "regression": (({"a": 0.5, "b": 0.7}, {"a": 0.45, "b": 0.7}), {}),
    "within_tol": (({"a": 0.5}, {"a": 0.505}), {}),
    "timing_ignored": (({"a": 0.5}, {"a": 0.5}),
                       {"timing": {"t/batch64": 3.0}}),
    "missing": (({"a": 0.5, "b": 0.7}, {"a": 0.5}), {}),
    "per_record_tol": (({"a": 0.5}, {"a": 0.5 + 1e-5}), {"tol": 1e-6}),
    "per_record_tol_zero": (({"a": 0.5}, {"a": 0.5}), {"tol": 0.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_equals_reference(case):
    (base_vals, fresh_vals), kw = CASES[case]
    fresh, base = _pair(base_vals, fresh_vals, **kw)
    got = artifacts.compare_to_baseline(fresh, base)
    assert got == ref_artifacts.compare_to_baseline(fresh, base)
    assert (got == []) == (case in ("identical", "within_tol",
                                    "timing_ignored", "per_record_tol_zero"))


def test_compare_timing_changes_never_breach():
    fresh, base = _pair({"a": 0.5}, {"a": 0.5}, timing={"t": 1.0})
    fresh["records"][-1]["value"] = 1e9
    assert artifacts.compare_to_baseline(fresh, base) == []


def test_compare_rejects_figure_mismatch():
    fresh, base = _pair({"a": 0.5}, {"a": 0.5}, fresh_figure="other")
    got = artifacts.compare_to_baseline(fresh, base)
    assert got == ref_artifacts.compare_to_baseline(fresh, base)
    assert got and "figure mismatch" in got[0]


def test_compare_joins_reference_baseline_through_port_id():
    base = ref_artifacts.make_artifact(
        "fig", {}, _records({"zipf/LRU/k8/jnp/none": 0.5,
                             "zipf/LRU/k8/pallas/none": 0.5,
                             "robust-ladder/vmem-breach/rung": 2.0}))
    fresh = artifacts.make_artifact(
        "fig", {}, _records({"zipf/LRU/k8/torch/none": 0.5,
                             "zipf/LRU/k8/cuda/none": 0.5,
                             "robust-ladder/smem-breach/rung": 2.0}),
        device="cpu")
    assert artifacts.compare_to_baseline(fresh, base) == []
    fresh["records"][1]["value"] = 0.4
    assert artifacts.compare_to_baseline(fresh, base) == [
        "zipf/LRU/k8/cuda/none: hit_ratio 0.4000 vs baseline 0.5000 "
        "(delta -0.1000 > tol 0.01)"]
    # a baseline of the port's own kind is joined as it is
    assert artifacts.compare_to_baseline(fresh, fresh) == []


@pytest.mark.parametrize("ref_id,want", [
    ("zipf/LRU/k8/pallas/none", "zipf/LRU/k8/cuda/none"),
    ("zipf/LRU/k8/jnp/none", "zipf/LRU/k8/torch/none"),
    ("showdown-hr/zipf/lru/jnp-batched", "showdown-hr/zipf/lru/torch-batched"),
    ("showdown-hr/zipf/lru/pallas-resident",
     "showdown-hr/zipf/lru/cuda-resident"),
    ("robust-ladder/vmem-breach/rung", "robust-ladder/smem-breach/rung"),
    ("robust-clean/lru/jnp/violations", "robust-clean/lru/torch/violations"),
    ("zipf/LRU/k8/jnp/shard4", "zipf/LRU/k8/torch/shard4"),
    ("resident-eq/zipf/LRU/none", "resident-eq/zipf/LRU/none"),
    ("jnpx/xpallas/vmem_", "jnpx/xpallas/vmem_"),
    ("zipf/LRU/full/pallas: pallas backend requires ways <= 128",
     "zipf/LRU/full/cuda: cuda backend requires ways <= 128"),
])
def test_port_id(ref_id, want):
    assert port_id(ref_id) == want


def test_port_id_maps_quick_grid_onto_the_port_grid():
    """The 96 comparable ids of quick.json, through ``port_id``, are the
    port's quick grid (the other baselines' ids are held by running their
    figures in tests/test_torch_figures.py)."""
    from repro_torch.core.policies import Policy
    from repro_torch.eval.runner import HitRatioSpec

    base = artifacts.load_artifact(os.path.join(BASELINES, "quick.json"))
    spec = base["spec"]
    points, _ = HitRatioSpec(
        families=tuple(spec["families"]),
        policies=tuple(Policy[p] for p in spec["policies"]),
        assoc=tuple(spec["assoc"]), backends=("torch", "cuda"),
        capacity=spec["capacity"], n=spec["n"],
        seeds=tuple(spec["seeds"])).expand()
    cmp_ids = {port_id(r["id"]) for r in base["records"] if r["comparable"]}
    assert len(cmp_ids) == 96
    assert cmp_ids == {p.record_id for p in points}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_fig(monkeypatch):
    from repro_torch.eval import __main__ as cli
    calls = []

    def fig(quick=False, progress=None, device=None):
        calls.append((quick, device))
        return ({"quick": quick}, _records({"zipf/LRU/k8/torch/none": 0.5},
                                           timing={"t/batch64": 1.0}),
                ["zipf/LRU/sampled8/cuda: cuda backend does not support "
                 "sampled policies"])

    monkeypatch.setattr(cli, "FIGURES", {"stub": (fig, "stubfig")})
    return cli, calls


def test_cli_writes_artifact(stub_fig, tmp_path):
    cli, calls = stub_fig
    out = tmp_path / "a.json"
    assert cli.main(["--fig", "stub", "--quick", "--out", str(out),
                     "--device", "cpu", "--quiet"]) == 0
    art = artifacts.load_artifact(str(out))
    assert art["figure"] == "stubfig" and len(art["records"]) == 2
    assert calls == [(True, "cpu")]


def test_cli_baseline_gate_exit_codes(stub_fig, tmp_path):
    cli, _ = stub_fig
    base = tmp_path / "base.json"
    artifacts.write_artifact(str(base), ref_artifacts.make_artifact(
        "stubfig", {}, _records({"zipf/LRU/k8/jnp/none": 0.5})))
    args = ["--fig", "stub", "--device", "cpu", "--quiet", "--out",
            str(tmp_path / "a.json"), "--baseline", str(base)]
    assert cli.main(args) == 0
    artifacts.write_artifact(str(base), ref_artifacts.make_artifact(
        "stubfig", {}, _records({"zipf/LRU/k8/jnp/none": 0.6})))
    assert cli.main(args) == 2
    artifacts.write_artifact(str(base), ref_artifacts.make_artifact(
        "stubfig", {}, _records({"zipf/LRU/k4/jnp/none": 0.5})))
    assert cli.main(args) == 2


def test_cli_usage_errors(stub_fig):
    cli, _ = stub_fig
    for argv in (["--fig", "nope"], [],
                 ["--fig", "all", "--out", "x.json"],
                 ["--fig", "stub", "--device", "tpu"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2          # argparse's usage exit
