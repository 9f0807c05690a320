"""Each cell's whole harness path on the CPU at small sizes (the same
drivers, references, checks and readers as on the card), the result
line's keys, and the run's refusals."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import small
from bench import limits, main, registry

orig_limits = limits.limits_of

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 12345


def run_cell(name, trace, seed=SEED, seconds=None):
    t0 = time.perf_counter()
    seconds = seconds or small.seconds(name)
    return main.execute(BENCH, name, seed, seconds, trace,
                        torch.device("cpu"),
                        lambda: time.perf_counter() - t0,
                        config=small.config(name),
                        traffic=small.traffic(name))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_checks(name, trace, monkeypatch):
    small.steady_clock(monkeypatch, name)
    result, checks, setup_s = run_cell(name, bool(trace))
    assert setup_s > 0
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in registry.metrics_of(BENCH, kind, name)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        dev = result["device"]
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device and no card peak on the CPU: the device readers
        # find nothing to read and the metrics are left out
        for m in ("k3_roofline", "k5_roofline",
                  "device_idle.cache", "device_idle.serve", "serve_mfu"):
            assert m not in result["metrics"]


def test_serve_mix_without_sessions(monkeypatch):
    """A serving mix of fresh prompts alone (nothing primed) runs and
    checks correct through the same driver."""
    small.steady_clock(monkeypatch, "serve-sessions")
    wl = dict(registry.find(BENCH["workloads"], "serve-sessions",
                            "workload"), name="serve-fresh")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [wl])
    monkeypatch.setattr(limits, "limits_of",
                        lambda name: orig_limits("serve-sessions"))
    t0 = time.perf_counter()
    result, _, _ = main.execute(bench, "serve-fresh", SEED, 3.0, False,
                                torch.device("cpu"),
                                lambda: time.perf_counter() - t0,
                                config=small.config("serve-sessions"),
                                traffic=dict(small.FRESH))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("private_pages", [64, 6])
def test_serve_refused_lanes_replayed(private_pages, monkeypatch):
    """With few private pages the engine refuses lanes, whose transactions
    ran all the same: the check finds them from the engine's counters and
    still comes out correct."""
    small.steady_clock(monkeypatch, "serve-sessions")
    cfg = small.config("serve-sessions")
    cfg["engine"]["private_pages"] = private_pages
    run = main.Run(workload=registry.find(BENCH["workloads"],
                                          "serve-sessions", "workload"),
                   config=cfg, traffic=small.traffic("serve-sessions"),
                   seed=SEED, seconds=3.0, trace=False,
                   device=torch.device("cpu"), kind="cpu")
    cell = registry.driver("serve").Cell(run)
    cell.setup()
    cell.window(main.Tracer(False))
    cell.release()
    checks = {c.name: c for c in cell.check()}
    assert all(c.ok for c in checks.values()), checks
    refused = sum(r for txs, _ in cell.admit_txs for _, r in txs)
    assert (refused > 0) == (private_pages == 6)


def test_unknown_transaction_sequence_not_correct(monkeypatch):
    """Counters that no staged request accounts for make the sequence
    unknown, which fails ``correct`` under its own name."""
    from repro_torch.serve import engine
    small.steady_clock(monkeypatch, "serve-sessions")
    orig = engine.Engine.stats.fget
    monkeypatch.setattr(engine.Engine, "stats", property(
        lambda self: dict(orig(self), prefix_lookups=orig(
            self)["prefix_lookups"] + 1000 * self.ticks["admit"])))
    result, _, _ = run_cell("serve-sessions", False)
    assert result["checks"]["transactions_unknown"]["value"] > 0
    assert result["correct"] is False


def test_serving_mix_sizes():
    """The serving mix as committed: every prompt is a group's 640-token
    system prompt and a fresh 128-token question, 256 tokens out, and any
    64 consecutive requests draw nearly every group, none more than
    twice."""
    from bench import gen
    t = registry.traffic("serve-sessions")
    s = gen.RequestStream(t, 102400, SEED)
    groups = []
    for k in range(64):
        p, m = s.request(k)
        assert len(p) == 768 and m == 256
        groups.append(next(i for i, d in enumerate(s.docs)
                           if (p[:640] == d).all()))
    assert len(set(groups)) >= 56
    assert max(groups.count(g) for g in groups) <= 2


def test_trace_of_the_window_last_seconds(monkeypatch):
    """With ``last_s`` the profiler starts between two steps late in the
    window: the steps before it are known, the traced part has a span of
    its own, and the run checks correct."""
    import bench.drive_serve
    import bench.trace
    small.steady_clock(monkeypatch, "serve-sessions")
    monkeypatch.setattr(bench.trace, "time", bench.drive_serve.time)
    run = main.Run(workload=registry.find(BENCH["workloads"],
                                          "serve-sessions", "workload"),
                   config=small.config("serve-sessions"),
                   traffic=small.traffic("serve-sessions"), seed=SEED,
                   seconds=3.0, trace=True, device=torch.device("cpu"),
                   kind="cpu")
    cell = registry.driver("serve").Cell(run)
    cell.setup()
    with main.Tracer(True, 3.0, 1.0) as tr:
        cell.window(tr)
    cell.release()
    assert all(c.ok for c in cell.check())
    first, _ = run.records["traced_from"]
    assert 0 < first < len(run.records["steps"])
    assert tr.timeline is not None and tr.timeline.window_s > 0


def test_same_seed_same_inputs():
    from bench import gen
    a = gen.KeyStream(small.TRAFFIC["replay-ycsbc"]["keys"], SEED, "cpu")
    b = gen.KeyStream(small.TRAFFIC["replay-ycsbc"]["keys"], SEED, "cpu")
    assert torch.equal(a.draw(1000), b.draw(1000))
    s1 = gen.RequestStream(small.TRAFFIC["serve-sessions"], 512, SEED)
    s2 = gen.RequestStream(small.TRAFFIC["serve-sessions"], 512, SEED)
    for k in range(20):
        p1, m1 = s1.request(k)
        p2, m2 = s2.request(k)
        assert m1 == m2 and (p1 == p2).all()


def test_every_seed_same_sizes():
    """Every seed sends the same sizes in the same order, and any 64
    consecutive requests cover their ranges evenly; the tokens differ."""
    from bench import gen
    t = small.TRAFFIC["serve-sessions"]
    a, b = (gen.RequestStream(t, 512, s) for s in (1, 2**31 + 7))
    for k in range(64):
        (pa, ma), (pb, mb) = a.request(k), b.request(k)
        assert len(pa) == len(pb) and ma == mb
        assert not (pa[-8:] == pb[-8:]).all()
    lens = [a._span(k, 0, t["tail_tokens"]) for k in range(64)]
    news = [a._span(k, 1, t["max_new"]) for k in range(64)]
    assert abs(sum(lens) / 64 - 28) < 2 and abs(sum(news) / 64 - 6) < 0.5


def test_every_seed_same_key_layout():
    """The hot keys are the same catalog ids whatever the seed; the
    requests drawn differ."""
    from bench import gen
    t = small.TRAFFIC["replay-ycsbc"]["keys"]
    a, b = gen.KeyStream(t, 1, "cpu"), gen.KeyStream(t, 2**31 + 7, "cpu")
    assert torch.equal(a.perm, b.perm)
    ka, kb = a.draw(20000), b.draw(20000)
    assert not torch.equal(ka, kb)
    assert torch.mode(ka).values == torch.mode(kb).values == a.perm[0]


def _run_py(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    p = _run_py(["--workload", "replay-ycsbc", "--seed", "1", "--seconds",
                 "1", "--trace", "0"], os.path.dirname(PB))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone (no program)
    gives no result."""
    import shutil
    shutil.copy(os.path.join(os.path.dirname(PB), "BENCHMARK.json"),
                tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run_py(["--workload", "serve-sessions", "--seed", "1", "--seconds",
                 "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
