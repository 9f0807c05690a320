"""The readers of the program's own records (``repro_torch.obs``:
``portbench/metrics/{tick_gap_share,tick_host_ms,prefix_lanes_ms,
admit_prefill_ms,decode_step_ms,prefill_useful_share,k3_chain_ns}.py``) on
synthetic records and on missing ones, and ``program_trace.py``'s run of
each cell on the CPU at small sizes."""
import time
import types

import pytest
import torch

import program_trace
import small
from bench import main, registry
from repro_torch import obs

BENCH = registry.benchmark()
SEED = 2**31 + 4242
SERVE = program_trace.READERS["serve"]
ALL = SERVE + program_trace.READERS["replay"]


@pytest.fixture
def tracing():
    obs.clear()
    obs.enable()
    try:
        yield
    finally:
        obs.disable()
        obs.clear()


def read(name, run):
    return registry.metric_reader(name)(run)


def _tick(kind, host_ms, fetch_ms, phases, tick_ms, gap_ms):
    """One ``serve.step`` record with its ``serve.fetch`` child, at the
    given host milliseconds."""
    with obs.span("serve.step", kind=kind) as s:
        with obs.span("serve.fetch") as f:
            pass
    s.start_ns, s.end_ns = 0, int(host_ms * 1e6)
    f.start_ns, f.end_ns = 0, int(fetch_ms * 1e6)
    s.set(phases=[list(p) for p in phases], tick_ms=tick_ms, gap_ms=gap_ms)


def _serve_run(traced_from=None):
    """Four ticks (admit, decode, admit, decode: decode_block 2) and their
    harness records."""
    _tick("admit", 3.0, 1.0, [("prefix", 2.0), ("prefill", 300.0),
                              ("decode", 11.0), ("decode", 12.0)], 326.0,
          None)
    _tick("decode", 2.0, 1.5, [("decode", 10.0), ("decode", 11.0)], 22.0,
          2.0)
    _tick("admit", 4.0, 1.0, [("prefix", 4.0), ("prefill", 310.0),
                              ("decode", 12.0), ("decode", 13.0)], 340.0,
          4.0)
    _tick("decode", 5.0, 2.0, [("decode", 100.0), ("decode", 100.0)],
          201.0, 50.0)
    obs.count("serve.prefill_tokens_padded", 2 * 8 * 768)
    obs.count("serve.prefill_tokens_needed", 9216)
    return types.SimpleNamespace(records={
        "steps": [("admit", 0.0), ("decode", 0.0)] * 2,
        "traced_from": traced_from})


def test_serve_readers_on_synthetic_records(tracing):
    run = _serve_run()
    assert read("tick_host_ms", run) == pytest.approx(
        (2.0 + 0.5 + 3.0 + 3.0) / 4)
    assert read("prefix_lanes_ms", run) == pytest.approx(3.0)
    assert read("admit_prefill_ms", run) == pytest.approx(305.0)
    assert read("decode_step_ms", run) == pytest.approx(
        (11 + 12 + 10 + 11 + 12 + 13 + 100 + 100) / 8)
    # the first tick's gap is not measured: ticks 1-3 alone
    assert read("tick_gap_share", run) == pytest.approx(
        100 * 56.0 / (56.0 + 22.0 + 340.0 + 201.0))
    assert read("prefill_useful_share", run) == pytest.approx(75.0)


def test_serve_readers_leave_out_the_profiled_ticks(tracing):
    """With the profiler started at the fourth tick, the readers of spans
    read the first three alone; the counters cover the window."""
    run = _serve_run(traced_from=(3, 0))
    assert read("decode_step_ms", run) == pytest.approx(69 / 6)
    assert read("tick_gap_share", run) == pytest.approx(
        100 * 6.0 / (6.0 + 22.0 + 340.0))
    assert read("tick_host_ms", run) == pytest.approx(5.5 / 3)
    assert read("prefill_useful_share", run) == pytest.approx(75.0)


def test_serve_readers_none_on_missing_records(tracing):
    run = _serve_run()
    # ticks that do not match the harness's steps (no clear() before the
    # window)
    other = types.SimpleNamespace(records=dict(run.records,
                                               steps=run.records["steps"][:3]))
    for name in SERVE[:-1]:
        assert read(name, other) is None, name
    obs.clear()
    for name in ALL:
        assert read(name, run) is None, name
    assert read("tick_host_ms", types.SimpleNamespace(records={})) is None
    # CPU ticks: phases named, nothing measured on a device
    _tick("admit", 3.0, 1.0, [("prefix", None), ("prefill", None),
                              ("decode", None)], None, None)
    cpu = types.SimpleNamespace(records={"steps": [("admit", 0.0)],
                                         "traced_from": None})
    for name in ("tick_gap_share", "prefix_lanes_ms", "admit_prefill_ms",
                 "decode_step_ms"):
        assert read(name, cpu) is None, name
    assert read("tick_host_ms", cpu) == pytest.approx(2.0)


def test_k3_chain_ns_on_synthetic_records(tracing):
    run = types.SimpleNamespace(records={})
    assert read("k3_chain_ns", run) is None
    for ms in (40.0, 44.0):
        with obs.span("replay.kernel") as s:
            pass
        s.device_ms = [ms]
        obs.count("replay.chain_lanes", torch.tensor(1_000_000))
    assert read("k3_chain_ns", run) == pytest.approx(42.0)
    obs.clear()
    with obs.span("replay.kernel"):      # no device marks: not measured
        pass
    obs.count("replay.chain_lanes", 5)
    assert read("k3_chain_ns", run) is None


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_program_trace_runs_each_cell(name, monkeypatch):
    """The tracer's run of each cell on the CPU: correct, the tracer off
    and empty after it, the readers of host spans and counters read and
    the device readers not measured."""
    small.steady_clock(monkeypatch, name)
    out = program_trace.run_cell(BENCH, name, SEED, small.seconds(name),
                                 False, torch.device("cpu"),
                                 config=small.config(name),
                                 traffic=small.traffic(name))
    assert out["correct"], out["checks"]
    assert not obs.enabled() and obs.spans() == []
    m = out["metrics"]
    drive = small.traffic(name)["drive"]
    assert set(m) == set(program_trace.READERS[drive])
    if drive == "serve":
        assert m["tick_host_ms"] > 0
        assert 0 < m["prefill_useful_share"] <= 100
        assert all(m[k] is None for k in ("tick_gap_share", "decode_step_ms",
                                          "prefix_lanes_ms",
                                          "admit_prefill_ms"))
        b = out["breakdown"]
        assert b["admit"]["ticks"] >= 1 and b["decode"]["ticks"] >= 1
        assert b["admit"]["host_ms"] > 0 and b["admit"]["tick_ms"] is None
        assert b["decode"]["phase_ms"] == {}
    else:
        assert m["k3_chain_ns"] is None      # the plain version: no kernel


def test_benchmark_run_leaves_the_tracer_off():
    """The benchmark's own run neither turns the program's tracer on nor
    records into it."""
    obs.disable()
    obs.clear()
    t0 = time.perf_counter()
    result, _, _ = main.execute(BENCH, "replay-ycsbc", SEED, 0.3, False,
                                torch.device("cpu"),
                                lambda: time.perf_counter() - t0,
                                config=small.config("replay-ycsbc"),
                                traffic=small.traffic("replay-ycsbc"))
    assert result["correct"]
    assert not obs.enabled() and obs.spans() == [] and obs.counters() == {}
