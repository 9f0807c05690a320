"""The port's set-sharded cache (``repro_torch.core.sharded``) against
``repro.core.sharded`` (``jnp`` backend), bit for bit.

* ``access`` (with duplicates, two-phase, TinyLFU with per-shard
  sketches, overflow-defer), ``get`` with enable masks, ``put`` with
  admit masks and ``slot_value`` (global slot ids, the shared-way case of
  ``tests/test_router.py``) and ``peek_victims``, step by step from one
  state, on every lane of the stacked ``[D, S/D, k]`` state, the ``[D]``
  clocks and the sketch words, on the ``torch`` and ``cuda`` backends (the
  kernels' plain versions on the CPU);
* the paper's contract: LRU / LFU / FIFO sharded == unsharded in hits,
  evictions and final keys / vals (``tests/test_sharded.py``);
* the serving engine's host loop with ``EngineConfig(shards=D)`` against
  the reference's, run live.

Whole-trace replay is in ``tests/test_torch_sharded_replay.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import admission as jadm
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro.core.sharded import ShardedCache as JSharded
from repro.core.sharded import ShardedConfig as JShardedConfig
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch import configs
from repro_torch.core import admission, hashing
from repro_torch.core import kway as tkway
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.core.sharded import ShardedCache, ShardedConfig
from repro_torch.models import lm
from repro_torch.serve import engine as teng

torch.set_num_threads(1)

LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock", "expiry")


def _pair(policy, shards, backend="torch", num_sets=16, ways=4, **kw):
    j = JSharded(JShardedConfig(
        cache=JConfig(num_sets=num_sets, ways=ways,
                      policy=JPolicy(int(policy))), num_shards=shards, **kw))
    t = ShardedCache(ShardedConfig(
        cache=KWayConfig(num_sets=num_sets, ways=ways, policy=policy),
        num_shards=shards, backend=backend, **kw), device="cpu")
    return j, t


def _bits(x):
    """Any integer / bool array as its 32-bit pattern, for exact compares
    across uint32 (reference) and int32 (port) lanes."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.astype(np.int64) & 0xFFFFFFFF


def _assert_state(jst, tst, msg=""):
    got = tkway.state_to_numpy(tst)
    for leaf in LEAVES:
        want = getattr(jst, leaf)
        if want is None:
            assert leaf not in got, f"{msg}: {leaf}"
            continue
        np.testing.assert_array_equal(_bits(got[leaf]), _bits(want),
                                      err_msg=f"{msg}: {leaf}")


def _assert_sketch(jsk, tsk, msg=""):
    got = admission.sketch_to_numpy(tsk)
    for leaf in ("packed", "door", "additions"):
        np.testing.assert_array_equal(_bits(got[leaf]),
                                      _bits(getattr(jsk, leaf)),
                                      err_msg=f"{msg}: {leaf}")


def _assert_outs(jouts, touts, msg):
    for i, (a, b) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                      err_msg=f"{msg}: output {i}")


def _batch(rng, b=32, catalog=120):
    keys = rng.integers(0, catalog, b).astype(np.uint32)
    keys[: b // 4] = keys[0]                        # duplicates in the batch
    return keys, rng.random(b) < 0.8


#: (op, kwargs) per step, applied to both caches from one state
STEPS = ("access", "put", "get", "access", "peek", "put_slot", "two_phase",
         "get", "access", "put_slot")


@functools.lru_cache(maxsize=None)
def _reference_run(policy, shards):
    """The reference's outputs and states after every step (cached: the two
    port backends are held to one reference run)."""
    j, _ = _pair(policy, shards)
    rng = np.random.default_rng(int(policy) * 10 + shards)
    st = j.init()
    out = []
    for op in STEPS:
        keys, en = _batch(rng)
        vals = keys.astype(np.int32)
        if op == "access":
            st, *o = j.access(st, keys, vals)
        elif op == "two_phase":
            st, *o = j.access(st, keys, vals, two_phase=True)
        elif op == "get":
            st, *o = j.get(st, keys, enabled=en)
        elif op == "put":
            st, *o = j.put(st, keys, vals, admit=~en[::-1].copy(),
                           enabled=en)
        elif op == "put_slot":
            st, *o = j.put(st, keys, vals, enabled=en, slot_value=True)
        else:
            o = list(j.peek_victims(st, keys))
        out.append((keys, en, [np.asarray(x) for x in o],
                    jax.tree.map(np.asarray, st)))
    return out


@pytest.mark.parametrize("policy,shards", [
    (Policy.LRU, 2), (Policy.LRU, 4), (Policy.LFU, 4), (Policy.FIFO, 2),
    (Policy.RANDOM, 4), (Policy.HYPERBOLIC, 2)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ops_match_reference(policy, shards, backend):
    """access / two-phase access / get / put (admit, enable, slot_value) /
    peek_victims, 32 lanes over 16 sets: every output and every lane of
    the stacked state after each step."""
    _, t = _pair(policy, shards, backend)
    st = t.init()
    for step, (op, (keys, en, jo, jst)) in enumerate(
            zip(STEPS, _reference_run(policy, shards))):
        vals = keys.astype(np.int32)
        if op == "access":
            st, *o = t.access(st, keys, vals)
        elif op == "two_phase":
            st, *o = t.access(st, keys, vals, two_phase=True)
        elif op == "get":
            st, *o = t.get(st, keys, enabled=en)
        elif op == "put":
            st, *o = t.put(st, keys, vals, admit=~en[::-1].copy(),
                           enabled=en)
        elif op == "put_slot":
            st, *o = t.put(st, keys, vals, enabled=en, slot_value=True)
        else:
            o = list(t.peek_victims(st, keys))
        _assert_outs(jo, o, f"step {step} {op}")
        _assert_state(jst, st, f"step {step} {op}")


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tinylfu_access_threads_sketches(shards, backend):
    """Per-shard sketches ride through ``access`` and come back equal to
    the reference's, word for word; additions count each shard's lanes."""
    j, t = _pair(Policy.LFU, shards, backend)
    jtl = jadm.TinyLFUConfig(width=64, door_bits=128, sample=40)
    tl = admission.TinyLFUConfig(width=64, door_bits=128, sample=40)
    jst, tst = j.init(), t.init()
    jsk, tsk = j.init_sketches(jtl), t.init_sketches(tl)
    rng = np.random.default_rng(shards)
    for step in range(5):
        keys, _ = _batch(rng, catalog=90)
        vals = keys.astype(np.int32)
        jst, *jo, jsk = j.access(jst, keys, vals, tinylfu=jtl, sketches=jsk)
        tst, *to, tsk = t.access(tst, keys, vals, tinylfu=tl, sketches=tsk)
        _assert_outs(jo, to, f"step {step}")
        _assert_state(jst, tst, f"step {step}")
        _assert_sketch(jsk, tsk, f"step {step}")
    assert tsk.additions.shape == (shards,)


@pytest.mark.parametrize("capacity", [2, 5])
def test_overflow_defer_access(capacity):
    """With ``route_capacity`` below the batch, the deferred mask, the
    outputs (deferred lanes: no hit, value -1, no eviction) and the state
    equal the reference's."""
    j, t = _pair(Policy.LRU, 4, route_capacity=capacity)
    jst, tst = j.init(), t.init()
    rng = np.random.default_rng(capacity)
    for step in range(4):
        keys = rng.integers(0, 1 << 20, 32).astype(np.uint32)
        jst, *jo = j.access(jst, keys, keys.astype(np.int32),
                            return_deferred=True)
        tst, *to = t.access(tst, keys, keys.astype(np.int32),
                            return_deferred=True)
        _assert_outs(jo, to, f"step {step}")
        _assert_state(jst, tst, f"step {step}")
        assert to[-1].any()
        assert not (to[0] & to[-1]).any() and (to[1][to[-1]] == -1).all()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_put_slot_value_when_lanes_share_a_way(backend):
    """A present key refreshed and an insert victimizing its only way in
    one batch: both lanes land on one (set, way), and the stored payload
    is the global slot id once (tests/test_router.py:262), as in the
    reference."""
    j, t = _pair(Policy.LRU, 2, backend, num_sets=8, ways=1)
    cand = np.arange(1, 20_000, dtype=np.uint32)
    gset = hashing.set_index(t.backend.keys(cand), 8, 0x51CA).numpy()
    hot = np.bincount(gset, minlength=8)
    target = int(np.argmax(hot[4:]) + 4)           # a shard-1 set (>= S/D)
    k1, k2 = cand[gset == target][:2]
    jst, tst = j.init(), t.init()
    for keys in (np.asarray([k1]), np.asarray([k1, k2])):
        jst, *jo = j.put(jst, keys, np.zeros(len(keys), np.int32),
                         slot_value=True)
        tst, *to = t.put(tst, keys, np.zeros(len(keys), np.int32),
                         slot_value=True)
        _assert_outs(jo, to, "put")
        _assert_state(jst, tst, "put")
    assert (to[2].numpy() == target).all() and (to[3].numpy() == 0).all()
    gv = t.global_view(tst)
    stored = gv.keys != -1
    assert stored.any()
    assert (gv.vals[stored] == torch.arange(8)[:, None][stored]).all()
    for key in (k1, k2):
        if (gv.keys == int(np.int32(np.uint32(key).view(np.int32)))).any():
            tst, hit, v = t.get(tst, np.asarray([key], np.uint32))
            assert bool(hit[0]) and int(v[0]) == target


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.LFU, Policy.FIFO])
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_matches_unsharded(policy, shards):
    """The paper's disjoint-union claim: hits, evictions and the final
    keys / vals of the global view equal the unsharded cache's (meta and
    clocks are shard-local)."""
    cfg = KWayConfig(num_sets=16, ways=4, policy=policy)
    be = make_backend("cuda", cfg, device="cpu")
    sc = ShardedCache(ShardedConfig(cache=cfg, num_shards=shards),
                      device="cpu")
    s1, sd = be.init(), sc.init()
    rng = np.random.default_rng(int(policy) + shards)
    for _ in range(8):
        keys, _ = _batch(rng, catalog=200)
        s1, h1, v1, ek1, ev1 = be.access(s1, keys, keys.astype(np.int32))
        sd, h2, v2, ek2, ev2 = sc.access(sd, keys, keys.astype(np.int32))
        for a, b in ((h1, h2), (v1, v2), (ev1, ev2), (ek1[ev1], ek2[ev2])):
            assert torch.equal(a, b)
    gv = sc.global_view(sd)
    assert torch.equal(gv.keys, s1.keys) and torch.equal(gv.vals, s1.vals)


# ---------------------------------------------------------------------------
# the serving engine's sharded prefix cache (host loop)
# ---------------------------------------------------------------------------

ENGINE = dict(page=8, num_sets=4, ways=2, max_batch=4, max_seq=128,
              private_pages=96)


@functools.lru_cache(maxsize=None)
def _models():
    cfg = configs.get("deepseek-7b").smoke
    jcfg = jconfigs.get("deepseek-7b").smoke
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return cfg, jcfg, jparams, lm.params_from_numpy(cfg, tree, device="cpu")


def _prompts(vocab, n=6):
    r = np.random.default_rng(11)
    shared = r.integers(2, vocab - 1, 24)
    return [np.concatenate([shared, r.integers(2, vocab - 1, int(k))])
            for k in r.integers(1, 20, n)]


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=3)
    fin = eng.run()
    return {rid: (r.pages, r.prefix_hits, r.prefix_lookups)
            for rid, r in fin.items()}, fin, eng.stats


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_sharded_prefix_cache_matches_reference(backend):
    """``EngineConfig(shards=D)`` for D in {1, 2, 4}: stats, hit ratio,
    evictions, per-request pages (global slot ids) and prefix hits equal
    the reference engine's with the same shards, run live; the port's
    tokens equal across D (LRU is timestamp-order-invariant), as the
    reference asserts for its own (tests/test_serve_engine.py:146)."""
    cfg, jcfg, jparams, model = _models()
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for shards in (1, 2, 4):
        jrun, _, jst = _run(jeng.Engine(jcfg, jparams, jeng.EngineConfig(
            backend="jnp", shards=shards, **ENGINE)), prompts)
        teng_ = teng.Engine(cfg, model, teng.EngineConfig(
            backend=backend, shards=shards, **ENGINE), device="cpu")
        if shards > 1:
            assert isinstance(teng_.backend, ShardedCache)
        trun, tfin, tst = _run(teng_, prompts)
        assert trun == jrun and tst == jst, shards
        assert tst["prefix_hits"] > 0 and tst["evictions"] > 0
        runs[shards] = ({r: q.generated for r, q in tfin.items()},
                        tst, teng_.hit_ratio())
    assert runs[1] == runs[2] == runs[4]
