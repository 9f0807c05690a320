"""The port's in-program tracer (``repro_torch.obs``) and what records into
it, on the CPU: the serving tick (``serve/engine.py``: ``serve.step`` and
``serve.fetch`` spans, the phase hook, the prefill counters) and kernel 3's
launch (``kernels/replay.py``: the ``replay.kernel`` span and the
``replay.chain_lanes`` counter).  The device readings themselves need the
card: ``tests/test_torch_obs_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, obs
from repro_torch.kernels import replay as krp
from repro_torch.models import lm
from repro_torch.serve import engine as teng

torch.set_num_threads(1)

BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96, max_prompt=80, jitted=True, decode_block=2)


@pytest.fixture
def tracing():
    """Tracing on for one test, from a clean slate; off after it."""
    obs.clear()
    obs.enable()
    try:
        yield
    finally:
        obs.disable()
        obs.clear()


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_shares_one_noop():
    obs.disable()
    obs.clear()
    a, b = obs.span("a", x=1), obs.span("b")
    assert a is b
    with a as sp:
        sp.set(y=2)
    obs.count("n", 3)
    obs.count("n", torch.tensor(4))
    assert obs.spans() == [] and obs.counters() == {}
    assert not obs.enabled()


def test_spans_nest_with_their_parents(tracing):
    with obs.span("a", tick=0) as a:
        with obs.span("b"):
            with obs.span("c"):
                pass
        a.set(kind="admit")
        with obs.span("d"):
            pass
    with obs.span("e"):
        pass
    got = obs.spans()
    assert [s.name for s in got] == list("abcde")
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1]
    assert got[0].attrs == {"tick": 0, "kind": "admit"}
    assert all(s.end_ns >= s.start_ns > 0 for s in got)
    assert got[0].start_ns <= got[1].start_ns and got[1].end_ns <= \
        got[0].end_ns
    assert got[0].device_ms == [] and got[0].ms >= got[1].ms
    assert [s.name for s in obs.spans("d")] == ["d"]


def test_clear_drops_records_and_counters(tracing):
    with obs.span("a"):
        obs.count("n", 2)
    obs.clear()
    assert obs.spans() == [] and obs.counters() == {}
    assert obs.enabled()
    with obs.span("b"):
        pass
    assert [(s.name, s.parent) for s in obs.spans()] == [("b", -1)]


def test_tensor_counters_add_on_the_device_and_read_once(tracing):
    obs.count("n", 3)
    t = torch.tensor([4, 9], dtype=torch.int32)
    obs.count("n", t.max())
    obs.count("n", torch.tensor(5, dtype=torch.int64))
    obs.count("m", 1)
    # held as a tensor until read
    assert isinstance(obs._COUNTS["n"], torch.Tensor)
    assert obs.counters() == {"n": 17, "m": 1}


def test_spans_are_on_the_profilers_clock(tracing):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            with obs.span("inner"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"repro.outer", "repro.inner"} <= names


# ---------------------------------------------------------------------------
# the serving tick
# ---------------------------------------------------------------------------

_MODEL = {}


def _model():
    if not _MODEL:
        cfg = configs.get("deepseek-7b").smoke
        _MODEL["m"] = (cfg, lm.init_params(cfg, seed=0, device="cpu"))
    return _MODEL["m"]


def _prompts(vocab, n=9, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, 40)
    return [np.concatenate([shared, rng.integers(2, vocab - 1,
                                                 int(rng.integers(3, 14)))])
            for _ in range(n)]


def _serve(trace: bool, **kw):
    """A jitted engine built with tracing ``trace``, run to the end over
    the shared-prefix mix -> (engine, {rid: tokens})."""
    cfg, model = _model()
    (obs.enable if trace else obs.disable)()
    eng = teng.Engine(cfg, model, teng.EngineConfig(**dict(BASE, **kw)),
                      device="cpu")
    for p in _prompts(cfg.vocab_size):
        eng.submit(p, max_new=5)
    fin = eng.run()
    return eng, {rid: list(r.generated) for rid, r in fin.items()}


@pytest.mark.parametrize("kw", [{}, dict(decode_block=1, num_sets=4,
                                         ways=2, tinylfu=True)],
                         ids=["lru-burst", "tinylfu"])
def test_tracing_leaves_the_run_as_it_was(tracing, kw):
    """Tokens, stats, ticks and the graphs' launches are those of the same
    engine built with tracing off."""
    off, toks_off = _serve(False, **kw)
    assert obs.spans() == []
    on, toks_on = _serve(True, **kw)
    assert toks_on == toks_off
    assert on.stats == off.stats
    assert on.ticks == off.ticks
    assert on.graph_launches == off.graph_launches
    assert on._trace and not off._trace


def test_tick_records_its_phases_in_order(tracing):
    """One ``serve.step`` a tick with its ``serve.fetch`` child; the phase
    hook marks ``prefix``, ``prefill`` and ``decode_block`` decode steps on
    an admit tick and the decode steps alone on a decode tick; the device
    readings are not measured on the CPU."""
    eng, _ = _serve(True)
    steps = obs.spans("serve.step")
    assert len(steps) == sum(eng.ticks.values())
    kinds = [s.attrs["kind"] for s in steps]
    assert kinds.count("admit") == eng.ticks["admit"] >= 2
    assert kinds.count("decode") == eng.ticks["decode"] >= 1
    db = BASE["decode_block"]
    every = obs.spans()
    for i, s in enumerate(steps):
        assert s.attrs["tick"] == i
        want = (["prefix", "prefill"] if s.attrs["kind"] == "admit"
                else []) + ["decode"] * db
        assert [p for p, _ in s.attrs["phases"]] == want
        assert all(ms is None for _, ms in s.attrs["phases"])
        assert s.attrs["tick_ms"] is None and s.attrs["gap_ms"] is None
        me = every.index(s)
        fetch = [f for f in every if f.name == "serve.fetch"
                 and f.parent == me]
        assert len(fetch) == 1 and fetch[0].ms <= s.ms
    admitted = [r for s in steps for r in s.attrs.get("rids", [])]
    assert sorted(admitted) == sorted(eng.finished)


def test_prefill_counters_match_a_hand_count(tracing):
    eng, _ = _serve(True)
    ecfg = eng.ecfg
    padded = eng.ticks["admit"] * ecfg.max_batch * ecfg.max_prompt
    needed = sum(len(r.prompt) - r.prefix_hits * ecfg.page
                 for r in eng.finished.values())
    assert eng.stats["prefix_hits"] > 0
    assert obs.counters() == {"serve.prefill_tokens_padded": padded,
                              "serve.prefill_tokens_needed": needed}


def test_tracing_enabled_after_construction_times_nothing(tracing):
    """The engine reads the switch once: built with tracing off, its ticks
    still record host spans, but no phase and no device reading."""
    obs.disable()
    cfg, model = _model()
    eng = teng.Engine(cfg, model, teng.EngineConfig(**BASE), device="cpu")
    obs.enable()
    eng.submit(_prompts(cfg.vocab_size, n=1)[0], max_new=3)
    eng.run()
    steps = obs.spans("serve.step")
    assert steps and all("phases" not in s.attrs for s in steps)


# ---------------------------------------------------------------------------
# kernel 3's launch
# ---------------------------------------------------------------------------

def _buckets(num_sets=64, steps=6, batch=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    sets = torch.randint(0, num_sets, (steps, batch), generator=g,
                         dtype=torch.int32)
    sets[:, ::3] = 5                      # one hot owner
    en = torch.rand((steps, batch), generator=g) < 0.8
    return krp.bucket_lanes_ref(sets * 7, sets, en, num_sets), sets, en


def test_chain_lanes_is_the_largest_owner_bucket():
    bk, sets, en = _buckets()
    own = sets[en].long() >> krp.owner_shift(64)
    want = int(torch.bincount(own, minlength=krp.num_owners(64)).max())
    got = krp.chain_lanes(bk)
    assert got.dim() == 0 and int(got) == want


def test_traced_launch_records_span_and_counter(tracing):
    bk, _, _ = _buckets()
    for _ in range(3):
        with krp._traced_launch(bk, None):
            pass
    with krp._traced_launch(None, None):      # the block form: nothing
        pass
    assert [s.name for s in obs.spans()] == ["replay.kernel"] * 3
    assert obs.counters() == {"replay.chain_lanes":
                              3 * int(krp.chain_lanes(bk))}
    obs.disable()
    obs.clear()
    with krp._traced_launch(bk, None):
        pass
    assert obs.spans() == [] and obs.counters() == {}
