"""Whole-trace replay of the port's set-sharded cache against
``repro.core.sharded`` (``jnp`` backend), bit for bit.

``ShardedCache.replay``, scanned (each chunk routed, every shard stepped)
and resident (every chunk routed in one call, one ``CacheBackend.replay``
per shard: kernel 3's plain version, or kernel 4's with the hierarchy and
a private L1 per shard), flat, TinyLFU with per-shard sketches, TTLs,
two-phase and overflow-defer, on the ``torch`` and ``cuda`` backends:
hits, the deferred count and every lane of the final stacked state.  Then
``simulate.replay_batched(shards=D)`` against the reference's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import hierarchy as jh
from repro.core import simulate as jsim
from repro.core import traces as jtraces
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro.core.sharded import ShardedCache as JSharded
from repro.core.sharded import ShardedConfig as JShardedConfig
from repro_torch.core import admission, simulate
from repro_torch.core import hierarchy as th
from repro_torch.core import kway as tkway
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.core.sharded import ShardedCache, ShardedConfig

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


def _trace(n=1500, seed=5, catalog=1 << 9):
    tr = np.asarray(jtraces.generate("zipf", n, seed=seed, catalog=catalog),
                    np.uint32)
    tr[::17] = 0
    return tr


def _ttls(n, seed=3):
    r = np.random.default_rng(seed)
    return np.where(r.random(n) < 0.3, 0, r.integers(1, 400, n)).astype(
        np.int32)


#: (shards, policy, replay kwargs, ShardedConfig kwargs, batch)
REPLAYS = {
    "scan-lru-d4": (4, Policy.LRU, {}, {}, 64),
    "scan-hyperbolic-d2": (2, Policy.HYPERBOLIC, {}, {}, 32),
    "scan-two_phase-d2": (2, Policy.LFU, dict(two_phase=True), {}, 32),
    "scan-tinylfu-d2": (2, Policy.LFU, dict(tinylfu=True), {}, 32),
    "scan-ttl-d2": (2, Policy.LRU, dict(ttls=True), {}, 32),
    "scan-defer-d4": (4, Policy.LRU, {}, dict(route_capacity=4), 32),
    "resident-lru-d1": (1, Policy.LRU, dict(resident=True), {}, 64),
    "resident-lru-d8": (8, Policy.LRU, dict(resident=True), {}, 64),
    "resident-hyperbolic-d4": (4, Policy.HYPERBOLIC, dict(resident=True),
                               {}, 32),
    "resident-tinylfu-d4": (4, Policy.LRU, dict(resident=True, tinylfu=True),
                            {}, 32),
    "resident-ttl-d2": (2, Policy.FIFO, dict(resident=True, ttls=True), {},
                        32),
    "resident-defer-d8": (8, Policy.LRU, dict(resident=True),
                          dict(route_capacity=3), 32),
    "resident-hier-d2": (2, Policy.LRU, dict(resident=True, hierarchy=True),
                         {}, 16),
    "resident-hier-ttl-d2": (2, Policy.HYPERBOLIC,
                             dict(resident=True, hierarchy=True, ttls=True),
                             {}, 16),
}


@functools.lru_cache(maxsize=None)
def _reference_replay(name):
    shards, policy, kw, ckw, batch = REPLAYS[name]
    j, _ = _pair(policy, shards, **ckw)
    n = 400 if kw.get("hierarchy") else 1500
    tr = _trace(n)
    jkw = {}
    if kw.get("tinylfu"):
        jkw["tinylfu"] = jadm.TinyLFUConfig(width=64, door_bits=128,
                                            sample=200)
    if kw.get("ttls"):
        jkw["ttls"] = _ttls(n)
    if kw.get("hierarchy"):
        jkw["hierarchy"] = jh.HierarchyConfig(l1_sets=2, l1_ways=4)
    hits, defers, st = j.replay(tr, batch, two_phase=kw.get("two_phase",
                                                            False),
                                resident=kw.get("resident", False), **jkw)
    return tr, hits, defers, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("name", sorted(REPLAYS))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_replay_matches_reference(name, backend):
    """Whole-trace replay (the tail chunk padded): hits, deferred count and
    every lane of the final stacked state (both tiers of each shard with
    the hierarchy), equal to the reference's."""
    shards, policy, kw, ckw, batch = REPLAYS[name]
    tr, jhits, jdefers, jst = _reference_replay(name)
    _, t = _pair(policy, shards, backend, **ckw)
    tkw = {}
    if kw.get("tinylfu"):
        tkw["tinylfu"] = admission.TinyLFUConfig(width=64, door_bits=128,
                                                 sample=200)
    if kw.get("ttls"):
        tkw["ttls"] = _ttls(len(tr))
    if kw.get("hierarchy"):
        tkw["hierarchy"] = th.HierarchyConfig(l1_sets=2, l1_ways=4)
    hits, defers, st = t.replay(tr, batch,
                                two_phase=kw.get("two_phase", False),
                                resident=kw.get("resident", False), **tkw)
    assert (hits, defers) == (int(jhits), int(jdefers))
    assert hits > 0
    if "defer" in name:
        assert defers > 0
    if kw.get("hierarchy"):
        assert isinstance(st, th.HierState) and st.l1.keys.shape[0] == shards
        _assert_state(jst.l1, st.l1, "l1")
        _assert_state(jst.l2, st.l2, "l2")
    else:
        _assert_state(jst, st)


#: (shards, replay_batched kwargs, TinyLFU)
BATCHED = {
    "d1-scan": (1, {}, False), "d1-resident": (1, dict(resident=True), False),
    "d2-ttl": (2, dict(ttls=True), False), "d2-tinylfu": (2, {}, True),
    "d4-scan": (4, {}, False), "d4-hier": (4, dict(hierarchy=True), False),
    "d8-resident": (8, dict(resident=True), False),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_replay_batched_shards_matches_reference(name):
    """``simulate.replay_batched(shards=D)`` (scanned, resident, TTL,
    TinyLFU, the hierarchy) equals the reference's hit ratio, and without
    TinyLFU or the hierarchy the unsharded one (LRU)."""
    shards, kw, tl = BATCHED[name]
    tr = _trace(1000, seed=shards)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("ttls"):
        jkw["ttls"] = tkw["ttls"] = _ttls(len(tr))
    if kw.get("hierarchy"):
        jkw["hierarchy"] = jh.HierarchyConfig(l1_sets=2, l1_ways=4)
        tkw["hierarchy"] = th.HierarchyConfig(l1_sets=2, l1_ways=4)
    jsim_cfg = jsim.SimConfig(JConfig(num_sets=32, ways=4),
                              jadm.for_capacity(128) if tl else None)
    tsim = simulate.SimConfig(KWayConfig(num_sets=32, ways=4),
                              admission.for_capacity(128) if tl else None,
                              device="cpu")
    want = jsim.replay_batched(jsim_cfg, tr, batch=32, shards=shards, **jkw)
    got = simulate.replay_batched(tsim, tr, batch=32, shards=shards, **tkw)
    assert got == want > 0
    if not tl and not kw.get("hierarchy"):
        assert got == simulate.replay_batched(tsim, tr, batch=32, **tkw)


def test_replay_batched_shards_refuses_ref():
    sim = simulate.SimConfig(KWayConfig(num_sets=8, ways=2), backend="ref",
                             device="cpu")
    with pytest.raises(ValueError, match="cannot be sharded"):
        simulate.replay_batched(sim, np.arange(10, dtype=np.uint32),
                                shards=2)


def test_mesh_refused():
    """A mesh without a 'sets' axis of num_shards devices is refused with
    the reference's words."""
    with pytest.raises(ValueError, match="'sets' axis of exactly"):
        ShardedCache(ShardedConfig(cache=KWayConfig(num_sets=8, ways=2),
                                   num_shards=2), mesh=object(),
                     device="cpu")
