"""Kernel 3's set partition, on the CPU.

Kernel 3 (``csrc/replay.cu``) replays set ranges ("owners") in parallel.
It rests on three things, each held here bit for bit:

  * the premise: the chunked replay splits exactly by set.  Replaying each
    range of sets alone through the torch twin (``kway.replay_chunks``),
    with the lanes of the other sets disabled, gives the whole replay's
    rows, and the ranges' per-chunk hits and evictions sum to the whole
    replay's; one case also against ``repro.core.simulate``'s chunked scan;
  * the bucketing's plain version (``bucket_lanes_ref``): every enabled
    lane exactly once, owners in order, (t, i) order inside each owner;
  * the owner algorithm: ``_owner_replay`` below walks each owner's groups
    (its lanes of one chunk) in sub-batches of 32 lanes, with the per-set
    counts, the list of inserting lanes and the last-writer rule of the
    kernel's ``run_group``, and equals the twin.  The kernel itself is held
    to the twin on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core import simulate as jsim
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro_torch.core import admission, hashing, kway, router, simulate, traces
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy, victim_scores
from repro_torch.kernels import replay as krp

torch.set_num_threads(1)

ALL_POLICIES = list(Policy)
RANGES = 4


def _trace(cfg, batch, seed, hot=False):
    """Zipf over 3x the capacity (duplicate keys and same-set lanes in every
    chunk); ``hot``: one key is half of all requests."""
    n = max(600, 3 * batch)
    tr = traces.generate("zipf", n, seed=seed, catalog=cfg.capacity * 3)
    if hot:
        tr[::2] = tr[0]
    chunks, en = router.pad_chunks(tr, batch)
    en[-1, -3:] = False
    return (hashing.key_tensor(chunks, "cpu"), torch.from_numpy(en))


def _sets(cfg, qkeys):
    return kway.route(cfg, qkeys.reshape(-1))[1].reshape(qkeys.shape)


def _ttl_trace(batch, seed):
    keys, ttls = traces.generate_ttl("ttl_churn", 900, seed=seed, catalog=256,
                                     hot_ttl=600, churn_ttl=30)
    chunks, en = router.pad_chunks(keys, batch)
    tt = simulate._pad_ttl_chunks(ttls, batch)
    return (hashing.key_tensor(chunks, "cpu"), torch.from_numpy(en),
            torch.from_numpy(tt))


def _replay(cfg, qk, en, ttls=None):
    return kway.replay_chunks(lambda *a, **k: kway.access(cfg, *a, **k),
                              kway.make_cache(cfg, device="cpu"), qk, en, ttls)


def _rows(state, lo, hi):
    lanes = list(kway.STATE_LANES) + (["expiry"] if state.expiry is not None
                                      else [])
    return {f: getattr(state, f)[lo:hi] for f in lanes}


def _assert_partition(cfg, qk, en, ttls=None):
    """Each of RANGES set ranges replayed alone == the whole replay."""
    h, e, whole = _replay(cfg, qk, en, ttls)
    sets = _sets(cfg, qk)
    step = max(1, cfg.num_sets // RANGES)
    hs, es = torch.zeros_like(h), torch.zeros_like(e)
    for lo in range(0, cfg.num_sets, step):
        mine = (sets >= lo) & (sets < lo + step)
        h1, e1, part = _replay(cfg, qk, en & mine, ttls)
        hs += h1
        es += e1
        want, got = _rows(whole, lo, lo + step), _rows(part, lo, lo + step)
        for f in want:
            assert torch.equal(got[f], want[f]), (lo, f)
        assert torch.equal(part.clock, whole.clock)
    assert torch.equal(hs, h) and torch.equal(es, e)
    assert int(e.sum()) > 0
    return h, e, whole


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("batch", [1, 48, 333, 4100])
def test_partition_premise(policy, batch):
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    qk, en = _trace(cfg, batch, seed=int(policy) + batch)
    _assert_partition(cfg, qk, en)


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_partition_premise_ttl(policy):
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    qk, en, tt = _ttl_trace(48, seed=int(policy))
    _, _, whole = _assert_partition(cfg, qk, en, tt)
    assert int((whole.expiry != kway.NO_EXPIRY).sum()) > 0


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.HYPERBOLIC])
def test_partition_premise_hot_key(policy):
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    qk, en = _trace(cfg, 48, seed=3, hot=True)
    _assert_partition(cfg, qk, en)


@pytest.mark.parametrize("policy", [Policy.LFU, Policy.RANDOM])
def test_partition_premise_matches_reference(policy):
    """The ranges' summed hits and combined rows == repro.core.simulate's
    chunked scan of the whole trace."""
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    tr = traces.generate("zipf", 1500, seed=11, catalog=cfg.capacity * 3)
    chunks, en = jrouter.pad_chunks(tr, 48)
    jcfg = JConfig(num_sets=32, ways=4, policy=JPolicy(int(policy)))
    jhits, jst = jsim._replay_batched_scan(jsim.SimConfig(jcfg),
                                           jnp.asarray(chunks),
                                           jnp.asarray(en))
    h, _, whole = _assert_partition(cfg, hashing.key_tensor(chunks, "cpu"),
                                    torch.from_numpy(en))
    assert int(h.sum()) == int(jhits)
    got = kway.state_to_numpy(whole)
    for leaf in ("keys", "fprint", "vals", "meta_a", "meta_b", "clock"):
        np.testing.assert_array_equal(got[leaf], np.asarray(getattr(jst, leaf)),
                                      err_msg=leaf)


# ---------------------------------------------------------------------------
# the bucketing's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_sets", [1, 2, 32, 2**17, 2**20])
@pytest.mark.parametrize("batch", [1, 48, 333])
def test_bucket_lanes_ref(num_sets, batch):
    """Every enabled lane exactly once, owners in order, (t, i) order kept
    inside each owner; S = 1 and 2 (one owner of fewer sets than its
    range), 2^17 and 2^20 (8192 owners, most with no lanes)."""
    cfg = KWayConfig(num_sets=num_sets, ways=4)
    qk, en = _trace(cfg, batch, seed=batch)
    en[1::7] = False
    qk, sets = kway.route(cfg, qk.reshape(-1))
    qk = qk.reshape(en.shape)
    sets = sets.to(torch.int32).reshape(en.shape)
    bk = krp.bucket_lanes(qk, sets, en, num_sets)
    owners, shift = krp.num_owners(num_sets), krp.owner_shift(num_sets)
    assert owners == max(1, min(num_sets // 16, krp.MAX_OWNERS))
    assert bk.start.shape == (owners + 1,) and int(bk.start[0]) == 0
    m = int(en.sum())
    assert int(bk.start[-1]) == m
    lane = bk.lane[:m].long()
    assert torch.equal(torch.sort(lane).values,
                       torch.nonzero(en.reshape(-1))[:, 0])
    assert torch.equal(bk.key[:m], qk.reshape(-1)[lane])
    assert torch.equal(bk.set[:m], sets.reshape(-1)[lane])
    assert torch.equal(bk.pos[lane], torch.arange(m, dtype=torch.int32))
    own = bk.set[:m].long() >> shift
    assert bool((own[1:] >= own[:-1]).all())            # owners in order
    same = own[1:] == own[:-1]
    assert bool((lane[1:][same] > lane[:-1][same]).all())  # (t, i) order
    starts = torch.searchsorted(own, torch.arange(owners + 1))
    assert torch.equal(bk.start.long(), starts)
    if num_sets >= 2**17:
        assert int((bk.start[1:] == bk.start[:-1]).sum()) > 0
    assert torch.equal(bk.live, en.sum(1, dtype=torch.int32))


def test_bucket_segments_bounded():
    assert krp.bucket_segment(100) == krp.BUCKET_SEGMENT
    n = 2**22
    seg = krp.bucket_segment(n)
    assert seg % 32 == 0 and -(-n // seg) <= krp.MAX_SEGMENTS
    big = krp.bucket_segment(2**30 - 1)
    assert big % 32 == 0 and -(-(2**30 - 1) // big) <= krp.MAX_SEGMENTS


@pytest.mark.parametrize("batch,tinylfu,form", [
    (1, False, "owners"), (4100, False, "owners"), (1, True, "block"),
    (krp.TL_GRID_MIN_BATCH - 1, True, "block"),
    (krp.TL_GRID_MIN_BATCH, True, "grid"), (1024, True, "grid")])
def test_replay_form_by_shape(batch, tinylfu, form):
    assert krp.replay_form(batch, tinylfu) == form


# ---------------------------------------------------------------------------
# the owner algorithm of csrc/replay.cu, lane by lane
# ---------------------------------------------------------------------------

def _scores(cfg, st, row, now):
    """float32 victim scores of one row at time ``now`` (empty: -3e38)."""
    keys = torch.from_numpy(st["keys"][row])
    sc = victim_scores(cfg.policy, torch.from_numpy(st["meta_a"][row]),
                       torch.from_numpy(st["meta_b"][row]),
                       torch.tensor(now, dtype=torch.int32), keys)
    return np.where(keys.numpy() == hashing.EMPTY, np.float32(kway.NEG_INF),
                    sc.numpy())


def _probe(st, row, key):
    hit = np.nonzero(st["keys"][row] == key)[0]
    return int(hit[0]) if hit.size else -1


def _i32(x):
    return int(np.int64(x).astype(np.uint32).view(np.int32))


def _owner_replay(cfg, state, qk, en, ttls=None, tinylfu=None, sketch=None):
    """Kernel 3's owners / grid forms in Python: chunk by chunk (with
    TinyLFU the chunk's record first, on the whole sketch), each owner's
    group in sub-batches of 32 lanes as ``run_group`` runs it."""
    T, B = qk.shape
    W = cfg.ways
    qk, sets = kway.route(cfg, qk.reshape(-1))
    qk, sets = qk.reshape(T, B), sets.to(torch.int32).reshape(T, B)
    bk = krp.bucket_lanes(qk, sets, en, cfg.num_sets)
    shift = krp.owner_shift(cfg.num_sets)
    nsl = 1 << shift
    start = bk.start.tolist()
    lanes = list(zip(bk.lane.tolist(), bk.key.tolist(), bk.set.tolist()))
    fields = list(kway.STATE_LANES) + ["expiry"] * (ttls is not None)
    if ttls is not None:
        state = kway.ensure_expiry(state)
    st = {f: getattr(state, f).numpy().copy() for f in fields}
    ttl = None if ttls is None else ttls.reshape(-1).tolist()
    c0 = int(state.clock)
    cur = start[:-1]
    hits = np.zeros(T, np.int32)
    evs = np.zeros(T, np.int32)
    for t in range(T):
        base = c0 + 2 * B * t
        horizon = _i32(base + 2 * B)
        if tinylfu is not None:
            sketch = admission.record(tinylfu, sketch, qk[t], en[t])
        for o in range(len(cur)):
            end = cur[o]
            while end < start[o + 1] and lanes[end][0] // B == t:
                end += 1
            group, cur[o] = lanes[cur[o]:end], end
            if not group:
                continue
            if ttl is not None:                         # 0: lazy scrub
                for _, _, s in group:
                    dead = ((st["keys"][s] != hashing.EMPTY)
                            & (st["expiry"][s] <= horizon))
                    for f in fields:
                        st[f][s][dead] = {"keys": hashing.EMPTY,
                                          "expiry": kway.NO_EXPIRY}.get(f, 0)
            adm = [True] * len(group)
            if tinylfu is not None:                     # admit, pre-hit
                for j, (l, key, s) in enumerate(group):
                    if _probe(st, s, key) >= 0:
                        continue
                    vw = int(np.argmin(_scores(cfg, st, s, base + l - t * B)))
                    vkey = int(st["keys"][s][vw])
                    if vkey != hashing.EMPTY:
                        est = admission.estimate(
                            tinylfu, sketch, torch.tensor([key, vkey],
                                                          dtype=torch.int32))
                        adm[j] = bool(est[0] > est[1])
            n = [0] * nsl
            listed = []                                 # [key, i, sl, rank]
            for sb in range(0, len(group), 32):         # A
                sub = group[sb:sb + 32]
                elig = []
                for j, (l, key, s) in enumerate(sub):
                    w = _probe(st, s, key)
                    if w >= 0:
                        hits[t] += 1
                        if cfg.policy == Policy.LRU:
                            st["meta_a"][s, w] = max(st["meta_a"][s, w],
                                                     _i32(base + l - t * B))
                        elif cfg.policy in (Policy.LFU, Policy.HYPERBOLIC):
                            st["meta_a"][s, w] += 1
                    elig.append(w < 0 and adm[sb + j])
                first = []
                for j, (l, key, s) in enumerate(sub):
                    f = elig[j] and not any(elig[q] and sub[q][1] == key
                                            for q in range(j))
                    n0 = n[s & (nsl - 1)] if f else 0
                    if f and n0 < W and any(e[0] == key for e in listed):
                        f = False
                    first.append((f, n0))
                for j, (l, key, s) in enumerate(sub):
                    f, n0 = first[j]
                    if not f:
                        continue
                    sl = s & (nsl - 1)
                    rank = n0 + sum(first[q][0] and sub[q][2] & (nsl - 1) == sl
                                    for q in range(j))
                    if rank < W:
                        listed.append([key, l - t * B, sl, rank])
                    n[sl] = rank + 1
            for e in listed:                            # B
                row = (o << shift) + e[2]
                order = np.argsort(_scores(cfg, st, row, base + B + e[1]),
                                   kind="stable")
                e[3] = int(order[e[3]])
                evs[t] += st["keys"][row][e[3]] != hashing.EMPTY
            for k, (key, i, sl, w) in enumerate(listed):  # C
                if any(e[2] == sl and e[3] == w for e in listed[k + 1:]):
                    continue
                row, now = (o << shift) + sl, _i32(base + B + i)
                st["keys"][row, w] = key
                st["fprint"][row, w] = int(hashing.fingerprint(
                    torch.tensor([key], dtype=torch.int32))[0])
                st["vals"][row, w] = key
                a, b = {Policy.LRU: (now, 0), Policy.FIFO: (now, 0),
                        Policy.LFU: (1, 0), Policy.RANDOM: (0, 0),
                        Policy.HYPERBOLIC: (1, now)}[cfg.policy]
                st["meta_a"][row, w], st["meta_b"][row, w] = a, b
                if ttl is not None:
                    tt = ttl[t * B + i]
                    st["expiry"][row, w] = (_i32(base + 2 * B + tt) if tt > 0
                                            else kway.NO_EXPIRY)
    if ttl is not None and T:                           # final scrub
        final = _i32(c0 + 2 * B * T)
        dead = (st["keys"] != hashing.EMPTY) & (st["expiry"] <= final)
        for f in fields:
            st[f][dead] = {"keys": hashing.EMPTY,
                           "expiry": kway.NO_EXPIRY}.get(f, 0)
    out = kway.KWayState(**{f: torch.from_numpy(st[f]) for f in
                            kway.STATE_LANES},
                         clock=state.clock + 2 * B * T,
                         expiry=(torch.from_numpy(st["expiry"])
                                 if ttl is not None else None))
    return torch.from_numpy(hits), torch.from_numpy(evs), out, sketch


def _assert_same(got, want):
    for a, b, what in ((got[0], want[0], "hits"), (got[1], want[1], "evs")):
        assert torch.equal(a, b), what
    for f in list(kway.STATE_LANES) + ["clock", "expiry"]:
        x, y = getattr(got[2], f), getattr(want[2], f)
        assert (x is None) == (y is None), f
        assert x is None or torch.equal(x, y), f
    if want[3] is not None:
        for f in ("packed", "door", "additions"):
            assert torch.equal(getattr(got[3], f), getattr(want[3], f)), f


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("num_sets,ways,batch", [
    (32, 4, 1), (32, 4, 48), (32, 4, 333), (1, 8, 48), (2, 4, 100),
    (16, 2, 4100)])
def test_owner_algorithm_matches_twin(policy, num_sets, ways, batch):
    """Groups of more than 32 lanes (B 333, 4100; S 1, 2), duplicate keys
    and same-set lanes in every sub-batch, sets that fill (rank >= ways)."""
    cfg = KWayConfig(num_sets=num_sets, ways=ways, policy=policy)
    qk, en = _trace(cfg, batch, seed=int(policy) * 7 + batch)
    want = krp.replay_ref(cfg, kway.make_cache(cfg, device="cpu"), qk, en)
    got = _owner_replay(cfg, kway.make_cache(cfg, device="cpu"), qk, en)
    _assert_same(got, want)


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.HYPERBOLIC])
@pytest.mark.parametrize("batch", [48, 333])
def test_owner_algorithm_hot_key_and_ttl(policy, batch):
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    qk, en = _trace(cfg, batch, seed=5, hot=True)
    st0 = kway.make_cache(cfg, device="cpu")
    _assert_same(_owner_replay(cfg, st0, qk, en),
                 krp.replay_ref(cfg, st0, qk, en))
    qk, en, tt = _ttl_trace(batch, seed=int(policy))
    _assert_same(_owner_replay(cfg, st0, qk, en, tt),
                 krp.replay_ref(cfg, st0, qk, en, tt))


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.LFU])
@pytest.mark.parametrize("batch", [1, 64, 300])
def test_owner_algorithm_tinylfu_matches_twin(policy, batch):
    """The grid form's owner part (admit on the pre-hit state, estimate on
    the post-record sketch), with aging and a resumed sketch."""
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    tl = admission.TinyLFUConfig(width=64, door_bits=128, sample=250)
    qk, en = _trace(cfg, batch, seed=batch)
    half = qk.shape[0] // 2
    st0 = kway.make_cache(cfg, device="cpu")
    sk0 = admission.make_sketch(tl, "cpu")
    want = krp.replay_ref(cfg, st0, qk[:half], en[:half], tinylfu=tl,
                          sketch=sk0)
    got = _owner_replay(cfg, st0, qk[:half], en[:half], tinylfu=tl,
                        sketch=sk0)
    _assert_same(got, want)
    want = krp.replay_ref(cfg, want[2], qk[half:], en[half:], tinylfu=tl,
                          sketch=want[3])
    got = _owner_replay(cfg, got[2], qk[half:], en[half:], tinylfu=tl,
                        sketch=got[3])
    _assert_same(got, want)
