"""The port's device-resident serving tick (``EngineConfig(jitted=True)``)
on the CPU, where its body runs eagerly.

* ``core.hashing.prefix_block_hashes_t`` against the reference's
  ``prefix_block_hashes_jnp`` and the numpy form, bit for bit, and the
  reference's pinned chain values.
* ``serve.paged_model``'s capture-safe pool writers (``write_pages_sink``,
  ``decode_paged_sink``) against the host loop's forms and the reference's
  ``_write_pages_impl`` / ``_decode_paged_impl``: every page but the sink
  bit for bit (a repeated page id, skipped and inactive lanes), logits at
  the bf16 tolerance 3e-2; two active lanes on one page raise the flag.
* The tick against the reference's jitted engine, run live on the
  reference's weights (never its golden file, which the reference itself
  no longer meets), and against the port's host loop, on the reference's
  own tests' shapes (``tests/test_serve_jitted.py``): equal stats and hit
  ratio, and tokens equal up to a bf16 tie at the first divergence (the
  tick prefills lanes in a batch, the host loop one at a time).
* Out-of-page retirement, overflow queueing, the idle step, one ``_fetch``
  per tick, the watchdog over it, and one build per kind per engine.
* ``robust.watchdog.watch``, after ``tests/test_robust.py``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hashing as jh
from repro.core.policies import Policy as JPolicy
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro.serve import paged_model as jpm
from repro_torch import configs
from repro_torch.core import hashing as th
from repro_torch.core.policies import Policy
from repro_torch.models import lm
from repro_torch.robust import events
from repro_torch.robust.watchdog import WatchdogTimeout, watch
from repro_torch.serve import engine as teng
from repro_torch.serve import paged_model as tpm

torch.set_num_threads(1)

TOL = 3e-2
BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96, max_prompt=80)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _u32(t):
    return t.numpy().astype(np.uint32)


def test_prefix_hashes_t_pinned_values():
    t = np.random.default_rng(0).integers(0, 512, 67).astype(np.int32)
    padded = np.zeros(80, np.int32)
    padded[:67] = t
    got = _u32(th.prefix_block_hashes_t(torch.from_numpy(padded), 8))
    assert got[:4].tolist() == [1741624807, 425176065, 3914042232, 652229286]


@pytest.mark.parametrize("page,blocks", [(8, 1), (8, 5), (16, 32), (4, 64)])
def test_prefix_hashes_t_matches_reference(page, blocks):
    """Every block of every lane equals the traced reference's; the blocks
    of the real prompt equal the numpy form's; any int32 token value."""
    rng = np.random.default_rng(page * 100 + blocks)
    lanes = rng.integers(-2**31, 2**31, (3, blocks * page)).astype(np.int32)
    lanes[0] = rng.integers(0, 512, blocks * page)
    got = _u32(th.prefix_block_hashes_t(torch.from_numpy(lanes), page))
    assert got.shape == (3, blocks)
    for lane, row in zip(lanes, got):
        want = np.asarray(jh.prefix_block_hashes_jnp(jnp.asarray(lane), page))
        np.testing.assert_array_equal(row, want)
        n = int(rng.integers(1, blocks * page + 1))
        np.testing.assert_array_equal(
            row[: n // page], jh.prefix_block_hashes(lane[:n], page))
    assert (got != 0xFFFFFFFF).all()


# ---------------------------------------------------------------------------
# the capture-safe pool writers
# ---------------------------------------------------------------------------

_MODEL = {}


def _model():
    """(port cfg, reference cfg, reference params, port model) on the
    reference's weights, built once."""
    if not _MODEL:
        cfg = configs.get("deepseek-7b").smoke
        jcfg = jconfigs.get("deepseek-7b").smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _MODEL.update(cfg=cfg, jcfg=jcfg, jparams=jparams,
                      model=lm.params_from_numpy(cfg, tree, device="cpu"))
    return _MODEL["cfg"], _MODEL["jcfg"], _MODEL["jparams"], _MODEL["model"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pools(seed, cfg, total, page):
    """Random bf16 pools of ``total`` pages plus the sink: (reference
    pools without it, port pools with it)."""
    r = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, total + 1, page, cfg.hd)
    arrs = [jnp.asarray(r.standard_normal(shape), jnp.bfloat16)
            for _ in range(2)]
    port = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
            for a in arrs]
    return [a[:, :, :total] for a in arrs], port


def test_write_pages_sink_matches_both_forms():
    """Skipped (-1) and invalid lanes, a repeated page id (the last block
    wins): every page but the sink equals the host form's and the
    reference's, bit for bit."""
    cfg, jcfg, _, _ = _model()
    page, total = 8, 12
    (jk, jv), (tk, tv) = _pools(0, cfg, total, page)
    hk, hv = tk[:, :, :total].clone(), tv[:, :, :total].clone()
    r = np.random.default_rng(1)
    kv = [jnp.asarray(r.standard_normal((cfg.num_layers, 2, 4 * page,
                                         cfg.num_kv_heads, cfg.hd)),
                      jnp.bfloat16) for _ in range(2)]
    tkv = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
           for x in kv]
    slots = np.array([[3, -1, 7, 3], [5, 9, 0, 11]], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], bool)
    jk, jv = jpm._write_pages_impl(jcfg, tuple(kv), jnp.asarray(slots), jk,
                                   jv, jnp.asarray(valid))
    tpm.write_pages(cfg, tkv, torch.from_numpy(slots), hk, hv,
                    torch.from_numpy(valid))
    tpm.write_pages_sink(cfg, tkv, torch.from_numpy(slots), tk, tv,
                         torch.from_numpy(valid))
    for j, h, t in ((jk, hk, tk), (jv, hv, tv)):
        np.testing.assert_array_equal(_np(t[:, :, :total]), _np(j))
        np.testing.assert_array_equal(_np(t[:, :, :total]), _np(h))


def test_decode_paged_sink_matches_both_forms():
    """One decode step with inactive lanes: logits of the active lanes
    equal the host form's and are within 3e-2 of the reference's; the
    pools outside the sink equal the host form's bit for bit; no clash."""
    cfg, jcfg, jparams, model = _model()
    page, total, pps = 8, 28, 6
    (jk, jv), (tk, tv) = _pools(2, cfg, total, page)
    hk, hv = tk[:, :, :total].clone(), tv[:, :, :total].clone()
    r = np.random.default_rng(3)
    pt = r.permutation(total)[:4 * pps].reshape(4, pps).astype(np.int32)
    pos = np.array([13, 0, 40, 7], np.int32)
    active = np.array([True, False, True, True])
    tok = r.integers(2, cfg.vocab_size - 1, 4).astype(np.int32)
    args = [torch.from_numpy(a) for a in (tok, pos)]
    jl, jk, jv = jpm._decode_paged_impl(
        jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
        jnp.asarray(pt), jnp.asarray(active))
    hl, _, _ = tpm.decode_paged(cfg, model, *args, hk, hv,
                                torch.from_numpy(pt),
                                torch.from_numpy(active))
    sl, clash = tpm.decode_paged_sink(cfg, model, *args, tk, tv,
                                      torch.from_numpy(pt),
                                      torch.from_numpy(active))
    assert not bool(clash)
    np.testing.assert_array_equal(_np(sl)[active], _np(hl)[active])
    np.testing.assert_allclose(_np(sl)[active], _np(jl)[active], atol=TOL,
                               rtol=TOL)
    for j, h, t in ((jk, hk, tk), (jv, hv, tv)):
        np.testing.assert_array_equal(_np(t[:, :, :total]), _np(h))
        np.testing.assert_allclose(_np(t[:, :, :total]), _np(j), atol=TOL,
                                   rtol=TOL)


def test_decode_paged_sink_flags_two_lanes_on_one_page():
    """Where the host form raises, the sink form returns the flag; an
    inactive lane on the same page raises nothing."""
    cfg, _, _, model = _model()
    page, total = 8, 6
    _, (tk, tv) = _pools(4, cfg, total, page)
    pt = torch.tensor([[1, 2], [1, 3], [1, 4]], dtype=torch.int32)
    tok = torch.tensor([5, 6, 7], dtype=torch.int32)
    pos = torch.tensor([3, 5, 2], dtype=torch.int32)
    for active, want in (([True, True, False], True),
                         ([True, False, True], True),
                         ([True, False, False], False)):
        act = torch.tensor(active)
        _, clash = tpm.decode_paged_sink(cfg, model, tok, pos, tk, tv, pt,
                                         act)
        assert bool(clash) is want
        if want:
            with pytest.raises(AssertionError, match="two lanes"):
                tpm.decode_paged(cfg, model, tok, pos,
                                 tk[:, :, :total].clone(),
                                 tv[:, :, :total].clone(), pt, act)


# ---------------------------------------------------------------------------
# the tick against the reference's jitted engine and the port's host loop
# ---------------------------------------------------------------------------

def _prompts(vocab, seed=0, n=8, shared_len=40):
    """The reference tests' shared-prefix mix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, shared_len)
    return [np.concatenate([shared, rng.integers(2, vocab - 1,
                                                 int(rng.integers(3, 14)))])
            for _ in range(n)]


def _serve(side, kw, prompts, max_new):
    """-> ({rid: tokens}, hit ratio, stats, engine) of one engine run."""
    cfg, jcfg, jparams, model = _model()
    if side == "ref":
        kw = dict(kw, policy=JPolicy[kw.get("policy", Policy.LRU).name])
        kw.pop("backend", None)
        eng = jeng.Engine(jcfg, jparams, jeng.EngineConfig(jitted=True, **kw))
    else:
        eng = teng.Engine(cfg, model, teng.EngineConfig(
            jitted=side == "tick", **kw), device="cpu")
    for p in prompts:
        eng.submit(p, max_new=max_new)
    fin = eng.run()
    return ({rid: list(r.generated) for rid, r in fin.items()},
            eng.hit_ratio(), eng.stats, eng)


_NEXT_LOGITS = {}


def _ref_next_logits(seq):
    """The reference model's logits of the token after ``seq`` (a padded
    prefill of width max_seq)."""
    _, jcfg, jparams, _ = _model()
    padded = np.zeros((1, BASE["max_seq"]), np.int32)
    padded[0, :len(seq)] = seq
    logits, _, _ = jpm.prefill_padded(jcfg, jparams, jnp.asarray(padded),
                                      jnp.asarray([len(seq)], jnp.int32))
    return _np(logits[0])


def _assert_tokens_agree(name, prompts, want, got):
    """Same requests, same token counts; tokens equal, except that where a
    request's tokens first differ the reference's logits of the two must
    tie within the bf16 tolerance (the request is compared no further)."""
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w), (name, rid)
        for idx, (a, b) in enumerate(zip(w, g)):
            if a != b:
                la = _ref_next_logits(np.concatenate([prompts[rid], w[:idx]]))
                assert abs(la[a] - la[b]) <= TOL + TOL * abs(la[a]), (
                    f"{name} rid {rid} tok {idx}: {a} vs {b} is no bf16 tie")
                break


CASES = {
    "lru": ({}, {}, 6),
    "lfu-evict": (dict(policy=Policy.LFU, num_sets=4, ways=2), {}, 6),
    # the cuda backend's kernel wrappers take their plain versions on CPU
    # tensors: kernel 1 (peek_victims) and kernel 2 (access) in the tick
    "tinylfu": (dict(tinylfu=True, backend="cuda"), {}, 6),
    "burst": (dict(decode_block=3), {}, 6),
    "out-of-pages-db1": (dict(private_pages=7), dict(n=10), 50),
    "out-of-pages-db3": (dict(private_pages=7, decode_block=3), dict(n=10),
                         50),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    kw, pkw, max_new = CASES[request.param]
    kw = dict(BASE, **kw)
    prompts = _prompts(_model()[0].vocab_size, **pkw)
    return (request.param, prompts,
            *(_serve(side, kw, prompts, max_new)
              for side in ("ref", "tick", "host")))


def test_tick_matches_reference_jitted(served):
    name, prompts, (jg, jhr, jst, _), (tg, thr, tst, _), _ = served
    assert tst == jst
    assert thr == jhr
    _assert_tokens_agree(name, prompts, jg, tg)


def test_tick_matches_host_loop(served):
    name, prompts, _, (tg, thr, tst, _), (hg, hhr, hst, _) = served
    assert tst == hst
    assert thr == hhr
    _assert_tokens_agree(name, prompts, hg, tg)


def test_tick_cases_exercise_their_paths(served):
    """Each case reaches what it is named for, and the sink page is never
    named by a page table."""
    name, prompts, _, (tg, _, st, eng), _ = served
    assert st["prefills"] == len(prompts) and st["decode_steps"] > 0
    assert eng.ticks["admit"] >= 1 and eng.ticks["decode"] >= 1
    if name == "lfu-evict":
        assert st["evictions"] > 0
    if name in ("lru", "burst"):
        assert st["prefix_hits"] > 0
    if name.startswith("out-of-pages"):
        assert min(len(g) for g in tg.values()) < 51, \
            "scenario must actually exhaust the page pool"
    sink = eng._state.pool_k.shape[2] - 1
    assert int(eng._state.page_tbl.max()) < sink
    assert not eng.running and not bool(eng._state.active.any())
    assert (eng._state.owner == -1).all()


def test_tick_overflow_queues():
    """More requests than slots: the overflow queues and every request
    finishes exactly once, as in the host loop."""
    prompts = _prompts(_model()[0].vocab_size, n=3 * BASE["max_batch"] + 1)
    tg, _, tst, _ = _serve("tick", BASE, prompts, 6)
    hg, _, hst, _ = _serve("host", BASE, prompts, 6)
    assert tst == hst
    _assert_tokens_agree("overflow", prompts, hg, tg)
    assert all(len(g) == 7 for g in tg.values())


def test_tick_backends_agree():
    """The torch and cuda (plain versions on CPU tensors) backends give the
    same tick, under TinyLFU and eviction pressure."""
    prompts = _prompts(_model()[0].vocab_size, seed=3, n=10)
    kw = dict(BASE, num_sets=4, ways=2, tinylfu=True)
    runs = [_serve("tick", dict(kw, backend=b), prompts, 4)[:3]
            for b in ("torch", "cuda")]
    assert runs[0] == runs[1]


def test_tick_idle_step_is_a_no_op():
    """Stepping an idle engine emits nothing and moves no counter."""
    cfg, _, _, model = _model()
    eng = teng.Engine(cfg, model, teng.EngineConfig(**BASE, jitted=True),
                      device="cpu")
    eng.submit(np.arange(2, 26, dtype=np.int32), max_new=3)
    fin = eng.run()
    before = eng.stats
    toks = {rid: list(r.generated) for rid, r in fin.items()}
    state = {k: v.clone() for k, v in vars(eng._state).items()
             if isinstance(v, torch.Tensor)}
    for _ in range(3):
        eng.step()
    assert eng.stats == before
    assert {rid: list(r.generated) for rid, r in fin.items()} == toks
    sink = eng._state.pool_k.shape[2] - 1
    for k, v in state.items():
        now = getattr(eng._state, k)
        if k.startswith("pool"):
            v, now = v[:, :, :sink], now[:, :, :sink]
        assert torch.equal(now, v), k


def test_tick_one_fetch_per_tick(monkeypatch):
    """The tick's host round trips: exactly one ``_fetch`` per step."""
    cfg, _, _, model = _model()
    eng = teng.Engine(cfg, model, teng.EngineConfig(**BASE, jitted=True),
                      device="cpu")
    for i in range(3):
        eng.submit(np.arange(2, 26 + i, dtype=np.int32), max_new=4)
    calls = []
    real = teng.Engine._fetch
    monkeypatch.setattr(teng.Engine, "_fetch",
                        lambda self: calls.append(1) or real(self))
    steps = 0
    while (eng.waiting or eng.running) and steps < 50:
        eng.step()
        steps += 1
    assert steps > 1 and len(calls) == steps == sum(eng.ticks.values())


def test_tick_sync_under_the_watchdog(monkeypatch):
    """With ``sync_timeout_s`` the one fetch runs under ``watch``: the same
    run, and a slow fetch is recorded as a degradation event, not lost."""
    prompts = _prompts(_model()[0].vocab_size, n=5)
    plain = _serve("tick", BASE, prompts, 4)
    real = teng.Engine._fetch
    slow = {"n": 0}

    def fetch(self):
        slow["n"] += 1
        if slow["n"] == 2:
            time.sleep(0.3)
        return real(self)

    monkeypatch.setattr(teng.Engine, "_fetch", fetch)
    watched = _serve("tick", dict(BASE, sync_timeout_s=0.05,
                                  sync_retries=6), prompts, 4)
    assert watched[0] == plain[0] and watched[1] == plain[1]
    assert watched[2]["degradation_events"] >= 1
    assert events.count(component="engine.tick_sync",
                        reason="sync_timeout") >= 1


def test_tick_build_economy(monkeypatch):
    """On the CPU the tick runs its body eagerly, exactly once per tick,
    and captures nothing (one capture per kind is the card's contract,
    held in tests/test_torch_gpu.py)."""
    cfg, _, _, model = _model()
    calls = []
    real = teng.Engine._body
    monkeypatch.setattr(teng.Engine, "_body",
                        lambda self, kind: (calls.append(kind),
                                            real(self, kind))[1])
    teng.reset_capture_counts()
    ticks = []
    for seed in (0, 1):
        eng = _serve("tick", BASE, _prompts(cfg.vocab_size, seed=seed, n=5),
                     6)[3]
        assert eng._graphs == {}
        ticks.append(dict(eng.ticks))
    assert teng.capture_counts() == {}
    assert {kind: calls.count(kind) for kind in teng.KINDS} == {
        kind: sum(t.get(kind, 0) for t in ticks) for kind in teng.KINDS}
    assert all(t.get("admit", 0) >= 1 and t.get("decode", 0) >= 1
               for t in ticks)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_passthrough_and_slow_recovery():
    assert watch(lambda: 41 + 1, timeout_s=0) == 42        # disabled
    c0 = events.cursor()
    out = watch(lambda: (time.sleep(0.25), "done")[1], timeout_s=0.05,
                retries=5, backoff=2.0, component="test.slow")
    assert out == "done"
    assert events.count(component="test.slow", reason="sync_timeout",
                        start=c0) >= 1


def test_watchdog_gives_up_and_propagates():
    hang = threading.Event()
    with pytest.raises(WatchdogTimeout):
        watch(hang.wait, timeout_s=0.02, retries=1, component="test.hang")
    hang.set()

    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        watch(boom, timeout_s=1.0)
