"""The rooflines' and serve_mfu's arithmetic against counts by hand, and
the readers' refusal to read what the trace lacks."""
import types

import numpy as np
import pytest
import torch

from bench import registry
from bench.trace import Timeline, idle_share

DEEPSEEK = dict(layers=30, d=4096, heads=32, kv_heads=32, head_dim=128,
                ff=11008, vocab=102400, eps=1e-6, theta=10000.0)
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return registry.metric_reader(name)


def mod(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), registry.ROOT / "metrics"
        / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def timeline(ops, window=(0, 10**9)):
    """ops: [(name, start ns, end ns, span)]"""
    from bench.trace import _union
    s = np.array([o[1] for o in ops], dtype=np.int64)
    e = np.array([o[2] for o in ops], dtype=np.int64)
    busy = sum(b - a for a, b in _union(s, e))
    return Timeline(window=window, names=[o[0] for o in ops], start=s,
                    end=e, span=[o[3] for o in ops], busy_ns=busy,
                    gaps={})


def test_k3_bytes_by_hand():
    m = mod("k3_roofline")
    assert m.replay_bytes(2**22, 2**20, 4096) == \
        4 * 4194304 + 2 * 5 * 4 * 1048576 + 8 * 4096 == 58753024
    tl = timeline([("owners_kernel", 0, 10**7, "replay"),
                   ("owners_kernel", 2 * 10**7, 3 * 10**7, "replay")])
    run = types.SimpleNamespace(kind=H100, timeline=tl, records=dict(
        replays=2, requests=2**22, capacity=2**20, steps=4096))
    want = 100 * 2 * 58753024 / 3.35e12 / 0.02
    assert m.read(run) == pytest.approx(want)
    run.records["replays"] = 3          # a record dropped: not measured
    assert m.read(run) is None
    run.kind = "cpu"
    assert m.read(run) is None


def test_bucketing_share_by_hand():
    tl = timeline([("owners_kernel", 0, 900, "replay"),
                   ("bucket_scatter", 900, 1000, "replay"),
                   ("Memcpy DtoH", 1000, 5000, "fetch")])
    run = types.SimpleNamespace(timeline=tl, records=dict(replays=1))
    assert reader("replay_bucketing_share")(run) == pytest.approx(10.0)


def test_idle_share_by_hand():
    tl = timeline([("a", 0, 300, None), ("b", 200, 400, None),
                   ("c", 600, 700, None)], window=(0, 1000))
    assert tl.busy_ns == 500
    assert idle_share(tl) == pytest.approx(50.0)
    assert idle_share(None) is None


def test_serve_params_by_hand():
    m = mod("serve_mfu")
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 4096 + 3 * 4096 * 11008 \
        + 2 * 4096
    assert m.params(DEEPSEEK) == 30 * per_layer + 4096 == 6071504896
    # with embedding and head: the published 6.9e9
    assert 6.90e9 < m.params(DEEPSEEK) + 2 * 102400 * 4096 < 6.92e9
    att = 4 * 32 * 128 * 30
    assert m.token_flops(DEEPSEEK, 9) == 2 * 6071504896 + att * 10
    assert m.prompt_flops(DEEPSEEK, 50, 32) == sum(
        m.token_flops(DEEPSEEK, p) for p in range(32, 50))


def _serve_records():
    rec = types.SimpleNamespace(
        prompt=np.zeros(40), admitted_in_window=True,
        req=types.SimpleNamespace(prefix_hits=2))
    old = types.SimpleNamespace(
        prompt=np.zeros(20), admitted_in_window=False,
        req=types.SimpleNamespace(prefix_hits=0))
    return dict(shape=DEEPSEEK, page=16, recs={1: rec, 2: old},
                emitted=[(1, 0, 3), (2, 5, 6)], decode_block=4,
                max_batch=8, steps=[("admit", 0.2), ("decode", 0.05)],
                traced_from=(0, 0))


def test_window_flops_by_hand():
    m = mod("serve_mfu")
    s = DEEPSEEK
    emit = 2 * 4096 * 102400
    want = (m.prompt_flops(s, 40, 32)                       # 8 after hits
            + 3 * emit + m.token_flops(s, 40) + m.token_flops(s, 41)
            + emit + m.token_flops(s, 24))
    assert m.window_flops(_serve_records()) == want
    run = types.SimpleNamespace(kind=H100, records=_serve_records(),
                                window_s=2.0)
    assert m.read(run) == pytest.approx(100 * want / 2.0 / 989e12)
    run.records["trace_start_s"] = 0.5
    assert m.read(run) == pytest.approx(100 * want / 1.5 / 989e12)


def test_k5_bound_by_hand():
    r = _serve_records()
    calls = 30 * 4 * 2
    tl = timeline([("paged_attention_kernel", i * 10, i * 10 + 5, "step")
                   for i in range(calls)])
    run = types.SimpleNamespace(kind=H100, timeline=tl, records=r)
    per_call = 2 * 8 * 32 * 128 * 2 + 4 * 8
    kv = 2 * 32 * 128 * 2
    nbytes = calls * per_call + 30 * (
        kv * 41 + 4 * 3 + kv * 42 + 4 * 3 + kv * 25 + 4 * 2)
    want = 100 * (nbytes / 3.35e12) / (calls * 5e-9)
    assert reader("k5_roofline")(run) == pytest.approx(want)
    run.timeline = timeline([("paged_attention_kernel", 0, 5, "step")])
    assert reader("k5_roofline")(run) is None
    # a trace that started at the second step: its calls and tokens only
    r["traced_from"] = (1, 1)
    run.timeline = timeline([("paged_attention_kernel", i * 10, i * 10 + 5,
                              "step") for i in range(calls // 2)])
    part = calls // 2 * per_call + 30 * (kv * 25 + 4 * 2)
    assert reader("k5_roofline")(run) == pytest.approx(
        100 * (part / 3.35e12) / (calls // 2 * 5e-9))
    r["traced_from"] = None
    assert reader("k5_roofline")(run) is None


def test_counter_readers_by_hand():
    r = dict(stats0={"prefix_hits": 10, "prefix_lookups": 20},
             stats1={"prefix_hits": 40, "prefix_lookups": 60},
             steps=[("admit", 0.2), ("decode", 0.05), ("admit", 0.4)])
    run = types.SimpleNamespace(records=r)
    assert reader("prefix_hit_share")(run) == pytest.approx(75.0)
    assert reader("admit_tick_ms")(run) == pytest.approx(300.0)
    assert reader("decode_tick_ms")(run) == pytest.approx(50.0)
    r["stats1"] = r["stats0"]
    assert reader("prefix_hit_share")(run) is None


def test_ttft_reader_by_hand():
    run = types.SimpleNamespace(records=dict(ttft=np.arange(1, 11) / 10))
    assert reader("ttft_p90_ms")(run) == pytest.approx(910.0)
    assert reader("ttft_p90_ms")(types.SimpleNamespace(records={})) is None
