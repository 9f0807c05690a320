"""The port's showdown harness (``repro_torch/showdown``) against the
reference's and the port's own replay: the host hash, the lock-striped
k-way cache's semantics and its bit-exactness with the sequential replay,
and the threaded harness's accounting.  ``cachetools`` is not installed
here; its tests skip, as the reference's do."""
import numpy as np
import pytest
import torch

from repro.showdown.baselines import LockStripedKWay as RefStriped
from repro.showdown.baselines import hash_u32_host as ref_hash_u32_host
from repro_torch.core import hashing, traces
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.core.simulate import SimConfig, replay
from repro_torch.showdown import (HAVE_CACHETOOLS, CachetoolsCache,
                                  LockStripedKWay, hit_ratio, make_baseline,
                                  replay_threaded)
from repro_torch.showdown.baselines import hash_u32_host
from repro_torch.showdown.harness import ThreadedReplay

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0x51CA, 0, 7])
def test_host_hash_matches_port_and_reference(seed):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 32, size=256, dtype=np.uint32)
    dev = hashing.hash_u32(hashing.key_tensor(keys, "cpu"), seed).numpy()
    host = np.asarray([hash_u32_host(int(k), seed) for k in keys], np.int64)
    ref = np.asarray([ref_hash_u32_host(int(k), seed) for k in keys],
                     np.int64)
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(ref, host)


def test_striped_lru_semantics_single_set():
    c = LockStripedKWay(num_sets=1, ways=2, policy="lru")
    assert not c.access(1)
    assert not c.access(2)
    assert c.access(1)
    assert not c.access(3)          # evicts 2
    assert c.access(1)
    assert not c.access(2)
    assert len(c) == 2


def test_striped_lfu_semantics_single_set():
    c = LockStripedKWay(num_sets=1, ways=2, policy="lfu")
    assert not c.access(1)
    assert c.access(1)              # count(1)=2
    assert not c.access(2)          # count(2)=1
    assert not c.access(3)          # evicts 2 (lowest count)
    assert c.access(1)
    assert not c.access(2)


def test_striped_validates_arguments():
    with pytest.raises(ValueError, match="power of two"):
        LockStripedKWay(num_sets=3, ways=2)
    with pytest.raises(ValueError, match="unknown striped policy"):
        LockStripedKWay(num_sets=2, ways=2, policy="fifo")
    with pytest.raises(ValueError, match="unknown baseline library"):
        make_baseline("redis", 64, "lru")
    with pytest.raises(ValueError, match="not divisible"):
        make_baseline("striped", 100, "lru", ways=8)


@pytest.mark.skipif(HAVE_CACHETOOLS, reason="cachetools is installed")
def test_cachetools_missing_raises_reference_error():
    with pytest.raises(ImportError, match="cachetools is not installed"):
        CachetoolsCache(8)
    with pytest.raises(ImportError, match="cachetools is not installed"):
        make_baseline("cachetools", 64, "lru")


@pytest.mark.skipif(not HAVE_CACHETOOLS, reason="cachetools not installed")
def test_cachetools_lru_semantics():
    c = CachetoolsCache(2, policy="lru")
    assert not c.access(1)
    assert not c.access(2)
    assert c.access(1)
    assert not c.access(3)
    assert c.access(1)
    assert not c.access(2)


@pytest.mark.parametrize("family", ["zipf", "oltp_mix"])
def test_striped_lru_is_bit_exact_with_sequential_replay(family):
    """Same set hash, same sentinel fold, same LRU victim rule: the striped
    cache gives the port's B=1 replay's hit ratio exactly."""
    tr = traces.generate(family, 3_000, seed=42)
    cfg = KWayConfig(num_sets=64, ways=8, policy=Policy.LRU)
    hr_port = replay(SimConfig(cache=cfg, backend="torch", device="cpu"), tr)
    hr_striped = hit_ratio(make_baseline("striped", 512, "lru", ways=8), tr)
    assert hr_striped == hr_port


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_striped_equals_reference_striped(policy):
    tr = traces.generate("zipf", 4_000, seed=9)
    port = LockStripedKWay(num_sets=32, ways=8, policy=policy)
    ref = RefStriped(num_sets=32, ways=8, policy=policy)
    keys = [int(k) for k in tr] + [0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
    assert [port.access(k) for k in keys] == [ref.access(k) for k in keys]


def test_hit_ratio_is_deterministic():
    tr = traces.generate("oltp_mix", 3_000, seed=1)
    a = hit_ratio(make_baseline("striped", 512, "lfu"), tr)
    b = hit_ratio(make_baseline("striped", 512, "lfu"), tr)
    assert a == b and 0.0 < a < 1.0


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_threaded_replay_covers_every_request(threads):
    tr = traces.generate("zipf", 1_000, seed=2)
    with ThreadedReplay(make_baseline("striped", 256, "lru"), tr,
                        threads) as rep:
        assert sum(len(s) for s in rep._slices) == len(tr)
        hits = rep()
        assert 0 <= hits <= len(tr)


def test_threaded_replay_rejects_no_threads():
    tr = traces.generate("zipf", 100, seed=2)
    with pytest.raises(ValueError, match="threads"):
        ThreadedReplay(make_baseline("striped", 256, "lru"), tr, 0)


def test_threaded_replay_single_thread_matches_hit_ratio():
    tr = traces.generate("zipf", 2_000, seed=3)
    with ThreadedReplay(make_baseline("striped", 512, "lfu"), tr, 1) as rep:
        hits = rep()
    assert hits / len(tr) == hit_ratio(make_baseline("striped", 512, "lfu"),
                                       tr)


def test_threaded_replay_under_watchdog():
    tr = traces.generate("zipf", 1_000, seed=6)
    with ThreadedReplay(make_baseline("striped", 256, "lru"), tr, 2,
                        timeout_s=30.0) as rep:
        assert 0 <= rep() <= len(tr)


def test_replay_threaded_stats_shape():
    tr = traces.generate("zipf", 1_000, seed=4)
    st = replay_threaded(make_baseline("striped", 256, "lru"), tr, 2,
                         iters=2, warmup=1)
    assert st["n"] == 1_000 and st["iters"] == 2
    assert st["reps_discarded"] == 1
    assert st["req_s_p50"] > 0
    assert 0 <= st["hits_last"] <= st["n"]


def test_concurrent_access_is_consistent():
    tr = traces.generate("zipf", 8_000, seed=5)
    cache = make_baseline("striped", 256, "lru", ways=8)
    with ThreadedReplay(cache, tr, 4) as rep:
        for _ in range(3):
            rep()
    assert len(cache) <= 256
    for d in cache._sets:
        assert len(d) <= cache.ways
