"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built with nvcc on first use); without a card each one skips.  Run them on
the card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The cache kernels' comparisons are exact: the cache is integer state, and
the scores are float32 computed the same way on both sides.  Paged
attention (kernel 5) sums in another order than its plain version, so it
is held at the reference's tolerances, 2e-5 in float32 and 3e-2 in
bfloat16.  The optimizer's update rounds each operation as its plain
version does: bit for bit at equal clip scales; its norm sums in another
order (in double), so it is held to a float64 sum at 1e-6.  This file
imports no JAX, so it runs where only torch is installed.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (admission, hashing, hierarchy, kway, router,
                              simulate, traces)
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import kway_probe as kp
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import replay as krp

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

ALL_POLICIES = list(Policy)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _warm_state(cfg, dev, n=3000, seed=5):
    """A state filled by a replay prefix on the torch twin."""
    be = make_backend("torch", cfg, dev)
    tr = traces.generate("zipf", n, seed=seed, catalog=cfg.capacity * 4)
    chunks, en = router.pad_chunks(tr, 64)
    _, _, state, _ = be.replay(be.init(), chunks, en)
    return state


#: widths of the probe kernels' tests: each lane-group width (1-32 lanes),
#: one past it, and 2 and 4 ways a lane
PROBE_WAYS = [1, 4, 8, 16, 17, 32, 33, 64, 128]


def _probe_batches(cfg, state, seed):
    """Raw key batches for kernels 1 and 2 (int32 tensors on the state's
    device): B 1, 257 and 16384 with duplicates, resident keys and EMPTY
    (0xFFFFFFFF, folded by the route), and 1000 keys of one set (more than
    a CTA of kernel 2 groups in shared memory)."""
    rng = np.random.default_rng(seed)
    resident = state.keys.flatten().cpu().numpy().view(np.uint32)
    resident = resident[resident != 0xFFFFFFFF]
    out = []
    for b in (1, 257, 16384):
        keys = rng.integers(0, cfg.capacity * 4, b).astype(np.uint32)
        keys[: b // 4] = keys[0]
        m = min(b // 4, len(resident))
        keys[b // 4: b // 4 + m] = rng.choice(resident, m)
        keys[rng.random(b) < 0.05] = 0xFFFFFFFF
        out.append(keys)
    cand = np.arange(1, 16 * cfg.ways * cfg.num_sets, dtype=np.uint32)
    sets = kway.route(cfg, torch.from_numpy(cand.view(np.int32)))[1].numpy()
    pool = np.concatenate([cand[sets == 0],
                           state.keys[0].cpu().numpy().view(np.uint32)])
    pool = pool[pool != 0xFFFFFFFF]
    out.append(pool[rng.integers(0, len(pool), 1000)])
    return [hashing.key_tensor(k, state.device) for k in out]


def _eq(a, b, what):
    assert torch.equal(a.cpu(), b.cpu()), what


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", PROBE_WAYS)
@pytest.mark.parametrize("variant", ["hits", "victim", "order"])
def test_kway_probe_kernel_matches_plain(cuda, policy, ways, variant):
    """Kernel 1 (one launch, the route inside) == its plain version, every
    output, at B 1, 257, 16384 and on a batch of one set."""
    cfg = KWayConfig(num_sets=64, ways=ways, policy=policy)
    st = _warm_state(cfg, cuda)
    kw = dict(policy=policy, full_order=variant == "order",
              need_victims=variant != "hits", num_sets=cfg.num_sets,
              seed=cfg.seed)
    for qk in _probe_batches(cfg, st, seed=ways):
        args = (st.keys, st.fprint, st.meta_a, st.meta_b, qk, st.clock)
        before = kp.LAUNCHES["kway_probe"]
        got = kp.kway_probe(*args, **kw)
        torch.cuda.synchronize()
        assert kp.LAUNCHES["kway_probe"] == before + 1
        want = kref.kway_probe_ref(*args, **kw)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype, f"output {i}"
            _eq(g, w, f"{policy.name}/{variant} B={len(qk)}: output {i}")


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", PROBE_WAYS)
def test_kway_fused_probe_kernel_matches_plain(cuda, policy, ways):
    """Kernel 2 (one launch, the route inside, no copy of meta_a) == its
    plain version, every output, at B 1, 257, 16384 and on a batch of one
    set, with an enable mask and with none; the state is left as it was."""
    cfg = KWayConfig(num_sets=32, ways=ways, policy=policy)
    st = _warm_state(cfg, cuda)
    lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
    saved = [t.clone() for t in lanes]
    rng = np.random.default_rng(1)
    for qk in _probe_batches(cfg, st, seed=ways + 7):
        b = qk.shape[0]
        for en in (torch.from_numpy(rng.random(b) < 0.8).to(cuda), None):
            args = (*lanes, qk, st.clock, en)
            kw = dict(policy=policy, num_sets=cfg.num_sets, seed=cfg.seed)
            before = kp.LAUNCHES["kway_fused_probe"]
            got = kp.kway_fused_probe(*args, **kw)
            torch.cuda.synchronize()
            assert kp.LAUNCHES["kway_fused_probe"] == before + 1
            want = kref.kway_fused_probe_ref(*args, **kw)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == w.dtype, f"output {i}"
                _eq(g, w, f"{policy.name} B={b} en={en is not None}: "
                          f"output {i}")
    for t, s in zip(lanes, saved):
        _eq(t, s, "state lanes written")


def test_kway_fused_probe_kernel_copies_no_state(cuda):
    """At 2^20 sets, kernel 2 leaves meta_a as it was and allocates its one
    output buffer (about 60 KiB at 1024 queries), far under the
    S x ways x 4 = 32 MiB that a copy of meta_a would take."""
    cfg = KWayConfig(num_sets=2**20, ways=8, policy=Policy.LRU)
    be = make_backend("cuda", cfg, cuda)
    tr = traces.generate("zipf", 2**16, seed=3, catalog=2**18)
    chunks, en = router.pad_chunks(tr, 1024)
    _, _, st, _ = be.replay(be.init(), chunks, en)
    qk = hashing.key_tensor(tr[-1024:], cuda)
    ma = st.meta_a.clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hit = kp.kway_fused_probe(st.keys, st.fprint, st.meta_a, st.meta_b, qk,
                              st.clock, None, num_sets=cfg.num_sets,
                              seed=cfg.seed, policy=cfg.policy)[2]
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert int(hit.sum()) > 0
    assert grew < cfg.num_sets * cfg.ways * 4 // 64, grew
    _eq(st.meta_a, ma, "meta_a written")


def _assert_states_equal(a, b, what):
    for f in kway.STATE_LANES + ("clock", "expiry"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f"{what}: {f}"
        else:
            _eq(x, y, f"{what}: {f}")


def _kernel3_equal(cfg, dev, chunks, en, form="owners", **kw):
    """Kernel 3 (one launch, in ``form``) == the torch twin == the cuda
    chunked path: per-chunk counts, state and sketch.  -> kernel's out."""
    cb = make_backend("cuda", cfg, dev)
    tb = make_backend("torch", cfg, dev)
    init = dict(ttl=True) if kw.get("ttls") is not None else {}
    krp.reset_trace_counts()
    got = cb.replay(cb.init(**init), chunks, en, **kw)
    torch.cuda.synchronize()
    tl = kw.get("tinylfu") is not None
    assert krp.trace_counts() == {
        ("launch", int(cfg.policy), cfg.num_sets, cfg.ways, chunks.shape[0],
         chunks.shape[1], bool(init), tl, form): 1}
    assert krp.launches("tinylfu" if tl else "flat") == 1
    for want, what in ((tb.replay(tb.init(**init), chunks, en, **kw),
                        "torch twin"),
                       (cb.replay_scan(cb.init(**init), chunks, en, **kw),
                        "cuda scan")):
        _eq(got[0], want[0], f"{what}: per-chunk hits")
        _eq(got[1], want[1], f"{what}: per-chunk evictions")
        _assert_states_equal(got[2], want[2], what)
        if tl:
            _assert_sketch_equal(got[3], want[3], what)
    return got


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways,batch", [(1, 50), (4, 64), (8, 1), (8, 333),
                                        (32, 96), (8, 4100)])
def test_replay_kernel_matches_chunked_twin(cuda, policy, ways, batch):
    """Groups (an owner's lanes of one chunk) of more than 32 lanes at B 333
    and 4100 walk the owner's list of inserting lanes across sub-batches."""
    cfg = KWayConfig(num_sets=32, ways=ways, policy=policy)
    tr = traces.generate("zipf", max(4000, 6 * batch), seed=ways,
                         catalog=cfg.capacity * 3)
    chunks, en = router.pad_chunks(tr, batch)
    h1, e1, _, _ = _kernel3_equal(cfg, cuda, chunks, en)
    assert int(e1.sum()) > 0


def _one_set_keys(cfg, n, seed):
    """n zipf-like draws from keys that all map to set 0."""
    cand = np.arange(1, 200 * cfg.num_sets * cfg.capacity, dtype=np.uint32)
    sets = kway.route(cfg, torch.from_numpy(cand.view(np.int32)))[1].numpy()
    pool = cand[sets == 0][: 4 * cfg.ways]
    rng = np.random.default_rng(seed)
    return pool[np.minimum(rng.zipf(1.3, n) - 1, len(pool) - 1)]


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("case", ["hot-key", "one-set", "sets-1", "sets-2",
                                  "sets-2^17", "max-batch"])
def test_replay_kernel_skew_and_edges(cuda, policy, case):
    """One key half of all requests; every lane in one set; an owner of 1
    or 2 sets; 8192 owners (131072 sets of 2 ways, so that 2^17 requests
    evict); B = MAX_BATCH."""
    sets, ways, batch, n = {
        "sets-1": (1, 8, 64, 3000), "sets-2": (2, 8, 64, 3000),
        "sets-2^17": (2**17, 2, 1024, 2**17),
        "max-batch": (32, 8, krp.MAX_BATCH, 3 * krp.MAX_BATCH),
    }.get(case, (32, 8, 256, 6000))
    cfg = KWayConfig(num_sets=sets, ways=ways, policy=policy)
    if case == "one-set":
        tr = _one_set_keys(cfg, n, int(policy))
    else:
        tr = traces.generate("zipf", n, seed=int(policy),
                             catalog=cfg.capacity * 3)
        if case == "hot-key":
            tr[::2] = tr[0]
    chunks, en = router.pad_chunks(tr, batch)
    en[-1, -3:] = False
    h, e, _, _ = _kernel3_equal(cfg, cuda, chunks, en)
    assert int(h.sum()) > 0 and int(e.sum()) > 0


@pytest.mark.parametrize("num_sets", [2**18, 2**20])
@pytest.mark.parametrize("tinylfu", [False, True])
def test_replay_kernel_wide_owners(cuda, num_sets, tinylfu):
    """Owners of 32 and 128 sets (``owner_shift`` 5 and 7) and their wider
    shared-memory scratch, at B = 1024, flat LRU and TinyLFU: == the torch
    twin and the cuda chunked path."""
    assert krp.owner_shift(num_sets) == {2**18: 5, 2**20: 7}[num_sets]
    cfg = KWayConfig(num_sets=num_sets, ways=2, policy=Policy.LRU)
    tr = traces.generate("zipf", num_sets, seed=num_sets % 97,
                         catalog=cfg.capacity * 3)
    chunks, en = router.pad_chunks(tr, 1024)
    kw = {}
    form = "owners"
    if tinylfu:
        kw = dict(tinylfu=admission.TinyLFUConfig(
            width=2**16, door_bits=2**17, sample=num_sets))
        form = "grid"
    h, e, _, _ = _kernel3_equal(cfg, cuda, chunks, en, form=form, **kw)
    assert int(h.sum()) > 0 and int(e.sum()) > 0


def test_cuda_replay_runs_the_chunked_path_beyond_kernel3(cuda):
    """2^23 sets x 8 ways at B = 8192: kernel 3's owners form would need
    409,600 B of shared memory per block, so ``CudaBackend.replay`` records
    one ``smem_budget`` event and runs the chunked path, launching no
    kernel 3; per-chunk hits and evictions and the final state equal the
    torch twin's."""
    from repro_torch.robust import events
    cfg = KWayConfig(num_sets=2**23, ways=8, policy=Policy.LRU)
    assert not krp.resident_fits(cfg, 8192, False, cuda)
    tr = traces.generate("zipf", 4 * 8192, seed=3, catalog=2**15)
    chunks, en = router.pad_chunks(tr, 8192)
    cb = make_backend("cuda", cfg, cuda)
    tb = make_backend("torch", cfg, cuda)
    krp.reset_trace_counts()
    cur = events.cursor()
    got = cb.replay(cb.init(), chunks, en)
    torch.cuda.synchronize()
    assert krp.trace_counts() == {}
    assert events.count(component="cuda.replay", reason="smem_budget",
                        start=cur) == 1
    want = tb.replay(tb.init(), chunks, en)
    _eq(got[0], want[0], "per-chunk hits")
    _eq(got[1], want[1], "per-chunk evictions")
    _assert_states_equal(got[2], want[2], "torch twin")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("num_sets", [1, 32, 2**17])
@pytest.mark.parametrize("batch", [1, 333, krp.MAX_BATCH])
def test_replay_bucket_kernel_matches_plain(cuda, num_sets, batch):
    """Kernel 3's bucketing (a stable counting sort by owner) == its plain
    version (a stable sort), on the positions that hold lanes."""
    cfg = KWayConfig(num_sets=num_sets, ways=8)
    n = max(20000, 3 * batch)
    tr = traces.generate("zipf", n, seed=batch, catalog=cfg.capacity * 3)
    chunks, en = router.pad_chunks(tr, batch)
    en[:, ::5] = False
    qk, sets = kway.route(cfg, hashing.key_tensor(chunks, cuda).reshape(-1))
    qk, sets = qk.view(chunks.shape), sets.to(torch.int32).view(chunks.shape)
    ent = torch.from_numpy(en).to(cuda)
    got = krp.bucket_lanes(qk, sets, ent, num_sets)
    want = krp.bucket_lanes_ref(qk.cpu(), sets.cpu(), ent.cpu(), num_sets)
    torch.cuda.synchronize()
    m = int(want.start[-1])
    _eq(got.start, want.start, "start")
    _eq(got.live, want.live, "live")
    for f in ("lane", "key", "set"):
        _eq(getattr(got, f)[:m], getattr(want, f)[:m], f)
    lanes = want.lane[:m].long()
    _eq(got.pos[lanes.to(cuda)], want.pos[lanes], "pos")


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_replay_kernel_ttl_matches_chunked_twin(cuda, policy):
    cfg = KWayConfig(num_sets=32, ways=4, policy=policy)
    keys, ttls = traces.generate_ttl("ttl_churn", 3000, seed=2, catalog=512,
                                     hot_ttl=900, churn_ttl=40)
    chunks, en = router.pad_chunks(keys, 48)
    tt = simulate._pad_ttl_chunks(ttls, 48)
    cb = make_backend("cuda", cfg, cuda)
    tb = make_backend("torch", cfg, cuda)
    h1, e1, s1, _ = cb.replay(cb.init(ttl=True), chunks, en, ttls=tt)
    h2, e2, s2, _ = tb.replay(tb.init(ttl=True), chunks, en, ttls=tt)
    h3, e3, s3, _ = cb.replay_scan(cb.init(ttl=True), chunks, en, ttls=tt)
    for h, e, s, what in ((h2, e2, s2, "torch twin"), (h3, e3, s3, "cuda scan")):
        _eq(h1, h, f"{what}: per-chunk hits")
        _eq(e1, e, f"{what}: per-chunk evictions")
        _assert_states_equal(s1, s, what)


def test_cuda_backend_runs_on_the_card_by_default(cuda):
    be = make_backend("cuda", KWayConfig(num_sets=8, ways=4))
    assert be.init().keys.device.type == "cuda"


def _assert_sketch_equal(a, b, what):
    _eq(a.packed, b.packed, f"{what}: sketch counters")
    _eq(a.door, b.door, f"{what}: sketch door")
    _eq(a.additions.reshape(()), b.additions.reshape(()),
        f"{what}: sketch additions")


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways,batch,n", [(4, 64, 5000), (8, 300, 5000),
                                          (32, 1500, 6000), (8, 1, 1500),
                                          (8, 1024, 8192)])
@pytest.mark.parametrize("form", ["grid", "block"])
def test_replay_kernel_tinylfu_matches_chunked_twin(cuda, monkeypatch,
                                                   policy, ways, batch, n,
                                                   form):
    """Kernel 3's TinyLFU branch, in each form whatever the batch (the
    narrow-chunk rule moved), == the torch chunked loop (record -> peek ->
    admit -> access) == the cuda chunked path (kernels 1 and 2), with a
    sample short enough to age several times and a resumed sketch."""
    monkeypatch.setattr(krp, "TL_GRID_MIN_BATCH",
                        1 if form == "grid" else krp.MAX_BATCH + 1)
    cfg = KWayConfig(num_sets=32, ways=ways, policy=policy)
    tl = admission.TinyLFUConfig(width=64, door_bits=128, sample=700)
    tr = traces.generate("zipf", n, seed=ways, catalog=cfg.capacity * 3)
    chunks, en = router.pad_chunks(tr, batch)
    sk0 = admission.make_sketch(tl, cuda)
    _kernel3_equal(cfg, cuda, chunks, en, form, tinylfu=tl, sketch=sk0)
    cb = make_backend("cuda", cfg, cuda)
    tb = make_backend("torch", cfg, cuda)
    # resumed: the second half of the trace from the first half's state
    half = chunks.shape[0] // 2
    _, _, sa, ka = cb.replay(cb.init(), chunks[:half], en[:half], tinylfu=tl)
    hb, eb, sb, kb = cb.replay(sa, chunks[half:], en[half:], tinylfu=tl,
                               sketch=ka)
    _, _, sc, kc = tb.replay(tb.init(), chunks[:half], en[:half], tinylfu=tl)
    hc, ec, sc, kc = tb.replay(sc, chunks[half:], en[half:], tinylfu=tl,
                               sketch=kc)
    _eq(hb, hc, "resumed: per-chunk hits")
    _eq(eb, ec, "resumed: per-chunk evictions")
    _assert_states_equal(sb, sc, "resumed")
    _assert_sketch_equal(kb, kc, "resumed")


def _hier_run(cfg, dev, n, seed, ttl):
    if ttl:
        keys, ttls = traces.generate_ttl("ttl_churn", n, seed=seed,
                                         catalog=cfg.capacity * 2,
                                         hot_ttl=300, churn_ttl=30)
    else:
        keys = traces.generate("zipf", n, seed=seed,
                               catalog=cfg.capacity * 4)
    chunks, en = router.pad_chunks(keys, 24)
    en[-1, -5:] = False
    tt = simulate._pad_ttl_chunks(ttls, 24) if ttl else None
    be = make_backend("cuda", cfg, dev)
    return be, chunks, en, tt


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("promote", [True, False])
@pytest.mark.parametrize("demote", [True, False])
@pytest.mark.parametrize("ttl", [False, True], ids=["plain", "ttl"])
def test_replay_hier_kernel_matches_plain(cuda, policy, promote, demote, ttl):
    """Kernel 4 == hierarchy.replay_l1_over_l2: per-chunk hits and
    evictions and both tiers, exactly."""
    cfg = KWayConfig(num_sets=16, ways=4, policy=policy)
    hc = hierarchy.HierarchyConfig(l1_sets=4, l1_ways=4, promote=promote,
                                   demote=demote)
    be, chunks, en, tt = _hier_run(cfg, cuda, 500, int(policy), ttl)
    krp.reset_trace_counts()
    h1, e1, s1, _ = be.replay(be.init(ttl=ttl), chunks, en, hierarchy=hc,
                              ttls=tt)
    torch.cuda.synchronize()
    assert krp.launches("hier") == 1
    st0 = hierarchy.make_hier(cfg, hc, device="cpu", ttl=ttl)
    h2, e2, s2, _ = hierarchy.replay_l1_over_l2(cfg, hc, st0, chunks, en,
                                                ttls=tt)
    _eq(h1, h2, "per-chunk hits")
    _eq(e1, e2, "per-chunk evictions")
    _assert_states_equal(s1.l1, s2.l1, "L1")
    _assert_states_equal(s1.l2, s2.l2, "L2")
    assert int(e1.sum()) > 0


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_replay_hier_kernel_wide_rows(cuda, policy):
    """Rows wider than one warp (each thread owns several ways), resumed
    from a filled hierarchy."""
    cfg = KWayConfig(num_sets=4, ways=40, policy=policy)
    hc = hierarchy.HierarchyConfig(l1_sets=2, l1_ways=48)
    be, chunks, en, _ = _hier_run(cfg, cuda, 1500, 9, False)
    half = chunks.shape[0] // 2
    _, _, st, _ = be.replay(be.init(), chunks[:half], en[:half],
                            hierarchy=hc)
    h1, e1, s1, _ = be.replay(st, chunks[half:], en[half:], hierarchy=hc)
    cpu = hierarchy.HierState(
        l1=kway.state_from_numpy(kway.state_to_numpy(st.l1), device="cpu"),
        l2=kway.state_from_numpy(kway.state_to_numpy(st.l2), device="cpu"))
    h2, e2, s2, _ = hierarchy.replay_l1_over_l2(cfg, hc, cpu, chunks[half:],
                                                en[half:])
    _eq(h1, h2, "per-chunk hits")
    _eq(e1, e2, "per-chunk evictions")
    _assert_states_equal(s1.l1, s2.l1, "L1")
    _assert_states_equal(s1.l2, s2.l2, "L2")


@pytest.mark.parametrize("seed", [0x1234, 0x7A11, 0x7FFFFFFF])
def test_replay_hier_kernel_routes_with_the_config_seed(cuda, seed):
    """Kernel 4 hashes keys to their L1 (salted seed) and L2 sets itself:
    equal to the plain version under seeds other than the default."""
    cfg = KWayConfig(num_sets=16, ways=4, policy=Policy.LRU, seed=seed)
    hc = hierarchy.HierarchyConfig(l1_sets=4, l1_ways=4)
    be, chunks, en, _ = _hier_run(cfg, cuda, 500, 3, False)
    h1, e1, s1, _ = be.replay(be.init(), chunks, en, hierarchy=hc)
    st0 = hierarchy.make_hier(cfg, hc, device="cpu")
    h2, e2, s2, _ = hierarchy.replay_l1_over_l2(cfg, hc, st0, chunks, en)
    _eq(h1, h2, "per-chunk hits")
    _eq(e1, e2, "per-chunk evictions")
    _assert_states_equal(s1.l1, s2.l1, "L1")
    _assert_states_equal(s1.l2, s2.l2, "L2")


def _hier_equal_plain(cfg, hc, dev, chunks, en, tt=None, form=None):
    """Kernel 4 from empty tiers == hierarchy.replay_l1_over_l2: per-chunk
    hits and evictions and both tiers, exactly; with ``form``, the L1 form
    that ran.  -> (hits, evictions)."""
    be = make_backend("cuda", cfg, dev)
    krp.reset_trace_counts()
    h1, e1, s1, _ = be.replay(be.init(ttl=tt is not None), chunks, en,
                              hierarchy=hc, ttls=tt)
    torch.cuda.synchronize()
    (key,) = krp.trace_counts()
    if form is not None:
        assert key[-1] == form
    st0 = hierarchy.make_hier(cfg, hc, device="cpu", ttl=tt is not None)
    h2, e2, s2, _ = hierarchy.replay_l1_over_l2(cfg, hc, st0, chunks, en,
                                                ttls=tt)
    _eq(h1, h2, "per-chunk hits")
    _eq(e1, e2, "per-chunk evictions")
    _assert_states_equal(s1.l1, s2.l1, "L1")
    _assert_states_equal(s1.l2, s2.l2, "L2")
    return h1, e1


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("l2_sets", [1, 2])
@pytest.mark.parametrize("ttl", [False, True], ids=["plain", "ttl"])
def test_replay_hier_kernel_tiny_l2_aliases_every_prefetch(cuda, policy,
                                                           l2_sets, ttl):
    """An L2 of 1 or 2 sets: nearly every L2 row the kernel copies ahead of
    its chain is one that the lanes in between store to (promote clears,
    in-place updates, demotions, scrubs)."""
    cfg = KWayConfig(num_sets=l2_sets, ways=8, policy=policy)
    hc = hierarchy.HierarchyConfig(l1_sets=4, l1_ways=4)
    _, chunks, en, tt = _hier_run(cfg, cuda, 1500, int(policy) + l2_sets,
                                  ttl)
    h, e = _hier_equal_plain(cfg, hc, cuda, chunks, en, tt)
    assert int(h.sum()) > 0 and int(e.sum()) > 0


@pytest.mark.parametrize("l1_sets", [1, 2])
def test_replay_hier_kernel_demotes_into_the_next_lanes_set(cuda, l1_sets):
    """Every lane's L1 victim is demoted into the L2 set that the next lane
    probes: one L1 set of 2 ways under LRU displaces lane i-2's key, and
    keys cycle over 3 L2 sets, so lane i+1's key shares that key's set.
    Four keys per set come back (L2 hits, promoted); every 7th lane brings
    a fresh key (L2 evictions).  With 2 L1 sets the victims follow no
    fixed order, but demotions still land in the sets the next lanes
    probe."""
    cfg = KWayConfig(num_sets=64, ways=4, policy=Policy.LRU)
    hc = hierarchy.HierarchyConfig(l1_sets=l1_sets, l1_ways=2)
    cand = torch.arange(1, 1 << 16, dtype=torch.int32)
    sets = hashing.set_index(hashing.sanitize_keys(cand), cfg.num_sets,
                             cfg.seed)
    pools = [cand[sets == s] for s in range(3)]
    keys = [int(pools[i % 3][4 + i // 7] if i % 7 == 0
                else pools[i % 3][(i // 3) % 4]) for i in range(3000)]
    chunks, en = router.pad_chunks(np.array(keys, dtype=np.uint32), 32)
    h, e = _hier_equal_plain(cfg, hc, cuda, chunks, en)
    assert int(h.sum()) > 500 and int(e.sum()) > 0


@pytest.mark.parametrize("over", [0, 1], ids=["at_the_limit", "just_over"])
def test_replay_hier_kernel_l1_at_the_shared_memory_limit(cuda, over):
    """The widest L1 of 512 sets whose lanes and the ring of prefetched L2
    rows fit the card's opt-in shared memory runs in the shared form; one
    way more runs in the global form.  Both equal the plain version."""
    cfg = KWayConfig(num_sets=16, ways=8, policy=Policy.LRU)
    limit = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    ring, l1_way = krp.hier_smem_bytes(
        cfg, hierarchy.HierarchyConfig(l1_sets=512, l1_ways=1), False)
    ways = (limit - ring) // l1_way
    assert ways + 1 <= 32, "one ring layout for both cases"
    hc = hierarchy.HierarchyConfig(l1_sets=512, l1_ways=ways + over)
    form = "global" if over else "shared"
    assert krp.hier_l1_form(cfg, hc, False, cuda) == form
    # about 55 distinct keys per L1 set: the L1 fills and demotes into a
    # small L2, which evicts
    keys = traces.generate("zipf", 32000, seed=11, catalog=1 << 22)
    chunks, en = router.pad_chunks(keys, 256)
    _, e = _hier_equal_plain(cfg, hc, cuda, chunks, en, form=form)
    assert int(e.sum()) > 0


def _paged_inputs(dev, dtype, b, h, kvh, d, page, pages, pps, seed):
    """Random pools and queries; page tables drawn with replacement (so
    with repeats); sequence lengths include an empty and a full one."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    q = t(rng.standard_normal((b, h, d)).astype(np.float32))
    kpool = t(rng.standard_normal((kvh, pages, page, d)).astype(np.float32))
    vpool = t(rng.standard_normal((kvh, pages, page, d)).astype(np.float32))
    pt = rng.integers(0, pages, (b, pps)).astype(np.int32)
    sl = rng.integers(1, pps * page + 1, b).astype(np.int32)
    sl[0] = 0
    sl[-1] = pps * page
    return (q, kpool, vpool, torch.from_numpy(pt).to(dev),
            torch.from_numpy(sl).to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_paged_attention_kernel_matches_plain(cuda, d, g, dtype, tol):
    """Kernel 5 == its plain version on the card for every head dim of the
    repo's dense configs and GQA group sizes 1-8, with and without a
    softcap; empty and full sequences, page tables with repeats."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    kvh = 2
    args = _paged_inputs(cuda, dtype, 5, kvh * g, kvh, d, 16, 24, 6, d + g)
    for cap in (0.0, 30.0):
        before = kpa.LAUNCHES["paged_attention"]
        got = kpa.paged_attention(*args, softcap=cap)
        want = kref.paged_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        assert kpa.LAUNCHES["paged_attention"] == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.bfloat16:
            # both compute in float32 and round once: about two bf16 ulps
            torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                       rtol=8e-3)
        assert not got[0].any(), "an empty sequence gives zeros"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_paged_attention_kernel_stops_at_the_table(cuda, dtype, tol):
    """A seq_len past PPS x page attends only the table's PPS pages, as
    the plain version (and the TPU kernel's grid) do; the kernel reads no
    page-table entry past its sequence's row."""
    q, kpool, vpool, pt, sl = _paged_inputs(cuda, dtype, 4, 8, 2, 128, 16,
                                            12, 3, 5)
    sl = torch.tensor([3 * 16 + 1, 3 * 16 + 40, 1000, 17], dtype=torch.int32,
                      device=cuda)
    got = kpa.paged_attention(q, kpool, vpool, pt, sl, softcap=30.0)
    want = kref.paged_attention_ref(q, kpool, vpool, pt, sl, softcap=30.0)
    full = kref.paged_attention_ref(q, kpool, vpool, pt,
                                    sl.clamp(max=3 * 16), softcap=30.0)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(want, full, atol=0, rtol=0)


@pytest.mark.parametrize("page", [8, 32])
def test_paged_attention_kernel_page_sizes(cuda, page):
    """Pages other than 16 tokens, and a scale other than D^-0.5."""
    args = _paged_inputs(cuda, torch.float32, 3, 8, 2, 128, page, 10, 4, page)
    got = kpa.paged_attention(*args, scale=0.05, softcap=5.0)
    want = kref.paged_attention_ref(*args, scale=0.05, softcap=5.0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("kvh,pps", [(8, 128), (2, 16)],
                         ids=["wide", "narrow"])
def test_paged_attention_kernel_split_boundaries(cuda, kvh, pps, page, g,
                                                 dtype, tol):
    """Split-K at its edges: sequence lengths 0, 1, page - 1, page, exactly
    the end of the first split, one past it, the whole table and past it;
    the short ones leave every split but the first empty.  A wide grid
    (two pages per warp) and a narrow one (one page per CTA).  Each launch
    leaves its tickets at 0."""
    d = 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    esize = torch.empty((), dtype=dtype).element_size()
    _, ppc, splits = kpa.split_plan(page, d, esize, pps, 8, kvh, sms)
    assert splits > 1 and splits * ppc >= pps
    q, kpool, vpool, pt, _ = _paged_inputs(cuda, dtype, 8, kvh * g, kvh, d,
                                           page, 64, pps, page + g)
    sl = torch.tensor([0, 1, page - 1, page, ppc * page, ppc * page + 1,
                       pps * page, pps * page + 7], dtype=torch.int32,
                      device=cuda)
    for cap in (0.0, 30.0):
        got = kpa.paged_attention(q, kpool, vpool, pt, sl, softcap=cap)
        want = kref.paged_attention_ref(q, kpool, vpool, pt, sl, softcap=cap)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                       rtol=8e-3)
        assert not got[0].any(), "an empty sequence gives zeros"
    for tickets in kpa._TICKETS.values():
        assert not tickets.any(), "a launch left a ticket set"


def test_paged_attention_kernel_refuses_what_it_does_not_take(cuda):
    args = _paged_inputs(cuda, torch.float32, 2, 4, 2, 48, 8, 4, 2, 0)
    with pytest.raises(ValueError, match="head dim"):
        kpa.paged_attention(*args)
    q, kpool, vpool, pt, sl = _paged_inputs(cuda, torch.float32, 2, 4, 2, 64,
                                            8, 4, 2, 0)
    with pytest.raises(ValueError, match="dtype"):
        kpa.paged_attention(q.half(), kpool.half(), vpool.half(), pt, sl)
    with pytest.raises(ValueError, match="int32"):
        kpa.paged_attention(q, kpool, vpool, pt.long(), sl)


def _serve_engine(cfg, model, backend, dev, prompts):
    from repro_torch.serve.engine import Engine, EngineConfig
    eng = Engine(cfg, model, EngineConfig(
        page=8, num_sets=4, ways=4, max_batch=4, max_seq=128,
        private_pages=64, backend=backend), device=dev)
    for p in prompts:
        eng.submit(p, max_new=6)
    fin = eng.run()
    return eng, {rid: (r.generated, r.pages) for rid, r in fin.items()}


def test_engine_on_the_card_backends_agree(cuda):
    """The serving engine on the card: the cuda and torch prefix-cache
    backends give equal stats, pages and tokens, and every decode step
    launches kernel 5 once per layer."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get("deepseek-7b").smoke
    model = lm.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    shared = rng.integers(2, cfg.vocab_size - 1, 24)
    prompts = [np.concatenate([shared, rng.integers(2, cfg.vocab_size - 1,
                                                    int(n))])
               for n in rng.integers(1, 20, 6)]
    kpa.LAUNCHES["paged_attention"] = 0
    eng_c, out_c = _serve_engine(cfg, model, "cuda", cuda, prompts)
    assert kpa.LAUNCHES["paged_attention"] == \
        cfg.num_layers * eng_c.stats["decode_steps"] > 0
    eng_t, out_t = _serve_engine(cfg, model, "torch", cuda, prompts)
    assert eng_c.stats == eng_t.stats
    assert out_c == out_t


# ---------------------------------------------------------------------------
# the device-resident serving tick, captured as CUDA graphs
# ---------------------------------------------------------------------------

TICK_BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
                 private_pages=96, max_prompt=80, backend="cuda",
                 jitted=True)


def _tick_model(cuda):
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get("deepseek-7b").smoke
    return cfg, lm.init_params(cfg, seed=0, device=cuda)


def _tick_prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, 40)
    return [np.concatenate([shared, rng.integers(2, vocab - 1,
                                                 int(rng.integers(3, 14)))])
            for _ in range(n)]


def _state_tensors(st, sink):
    """Every tensor of a ServeState (the pools without the sink page)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            out[f.name] = v[:, :, :sink] if f.name.startswith("pool") else v
        else:
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)
                        if getattr(v, g.name) is not None})
    return out


@pytest.mark.parametrize("kw", [dict(), dict(tinylfu=True, num_sets=4,
                                             ways=2, decode_block=3)],
                         ids=["lru", "tinylfu-burst"])
def test_tick_replay_matches_the_eager_body(cuda, kw):
    """Each replayed tick leaves the state bit for bit where the same body
    run eagerly on the card leaves a copy of it (the sink page aside), and
    emits the same vector; the sink is never named by a page table."""
    import copy
    from repro_torch.serve import engine as teng
    cfg, model = _tick_model(cuda)
    eng = teng.Engine(cfg, model, teng.EngineConfig(**dict(TICK_BASE, **kw)),
                      device=cuda)
    assert set(eng._graphs) == set(teng.KINDS)
    sink = eng._state.pool_k.shape[2] - 1
    for p in _tick_prompts(cfg.vocab_size, 9):
        eng.submit(p, max_new=5)
    kinds = []
    steps = 0
    while (eng.waiting or eng.running) and steps < 100:
        admit = bool(eng.waiting) and len(eng.running) < eng.ecfg.max_batch
        eager = copy.deepcopy(eng._state)
        eng.step()
        want = teng._tick(cfg, eng.ecfg, eng.backend, eng.sketch_cfg, model,
                          eager, eng._batch.clone(), admit)
        torch.cuda.synchronize()
        got = _state_tensors(eng._state, sink)
        for name, t in _state_tensors(eager, sink).items():
            assert torch.equal(got[name], t), name
        assert torch.equal(eng._emitted, want.cpu())
        assert int(eng._state.page_tbl.max()) < sink
        kinds.append(admit)
        steps += 1
    assert not eng.waiting and not eng.running
    assert True in kinds and False in kinds


def test_tick_replays_do_not_sync(cuda, monkeypatch):
    """A whole run under ``set_sync_debug_mode("error")`` but for the one
    fetch per tick: no replay, and nothing else of the shell, syncs."""
    from repro_torch.serve import engine as teng
    cfg, model = _tick_model(cuda)
    eng = teng.Engine(cfg, model, teng.EngineConfig(**TICK_BASE),
                      device=cuda)
    for p in _tick_prompts(cfg.vocab_size, 6, seed=1):
        eng.submit(p, max_new=4)
    real = teng.Engine._fetch

    def fetch(self):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(self)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(teng.Engine, "_fetch", fetch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fin = eng.run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(fin) == 6 and eng.ticks["admit"] >= 1 \
        and eng.ticks["decode"] >= 1


def test_tick_captures_once_per_kind_and_matches_the_host_loop(cuda):
    """One capture per graph kind over a whole run, every tick a replay;
    each graph holds the kernel launches of its phases; the run's stats,
    hit ratio and token counts equal the host loop's."""
    from repro_torch.serve import engine as teng
    cfg, model = _tick_model(cuda)
    prompts = _tick_prompts(cfg.vocab_size, 3 * TICK_BASE["max_batch"] + 1,
                            seed=2)
    teng.reset_capture_counts()
    runs = {}
    for jitted in (True, False):
        eng = teng.Engine(cfg, model, teng.EngineConfig(
            **dict(TICK_BASE, jitted=jitted)), device=cuda)
        for p in prompts:
            eng.submit(p, max_new=6)
        fin = eng.run()
        runs[jitted] = (eng.stats, eng.hit_ratio(),
                        {rid: len(r.generated) for rid, r in fin.items()})
        if jitted:
            steps = sum(eng.ticks.values())
            graphs = eng.graph_launches
    counts = teng.capture_counts()
    # each graph holds one fused probe per lane (admit only) and one kernel
    # 5 launch per layer of each decode step
    assert graphs == {"admit": {"kway_fused_probe": TICK_BASE["max_batch"],
                                "paged_attention": cfg.num_layers},
                      "decode": {"paged_attention": cfg.num_layers}}, graphs
    assert sorted(k[-1] for k in counts) == sorted(teng.KINDS)
    assert all(v == 1 for v in counts.values()), counts
    assert steps > 2
    assert runs[True] == runs[False]


# ---------------------------------------------------------------------------
# set sharding and checkpoint / restore on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", ["flat", "ttl", "tinylfu", "defer",
                                  "hier"])
def test_sharded_resident_replay_matches_torch_twin(cuda, shards, mode):
    """Sharded resident replay on the ``cuda`` backend (D launches of
    kernel 3, or of kernel 4 with the hierarchy) against the sharded torch
    twin (on the card; on CPU tensors for the hierarchy, whose plain
    version walks lanes one at a time): hits, deferred count and every
    lane of the stacked state."""
    from repro_torch.core.sharded import ShardedCache, ShardedConfig
    cfg = KWayConfig(num_sets=1024, ways=8, policy=Policy.HYPERBOLIC
                     if mode == "flat" else Policy.LRU)
    n, batch = (2**11, 64) if mode == "hier" else (2**15, 256)
    tr = traces.generate("zipf", n, seed=shards, catalog=2**14)
    kw, ckw = {}, {}
    if mode == "ttl":
        kw["ttls"] = np.random.default_rng(1).integers(0, 3000, n).astype(
            np.int32)
    elif mode == "tinylfu":
        kw["tinylfu"] = admission.for_capacity(cfg.capacity)
    elif mode == "defer":
        ckw["route_capacity"] = batch // (2 * shards)
    elif mode == "hier":
        kw["hierarchy"] = hierarchy.HierarchyConfig(l1_sets=8, l1_ways=8)
    twin_dev = torch.device("cpu") if mode == "hier" else cuda
    kern = ShardedCache(ShardedConfig(cache=cfg, num_shards=shards,
                                      backend="cuda", **ckw), device=cuda)
    twin = ShardedCache(ShardedConfig(cache=cfg, num_shards=shards,
                                      backend="torch", **ckw),
                        device=twin_dev)
    krp.reset_trace_counts()
    got = kern.replay(tr, batch, resident=True, **kw)
    kind = {"hier": "hier", "tinylfu": "tinylfu"}.get(mode, "flat")
    assert krp.launches(kind) == shards
    want = twin.replay(tr, batch, resident=True, **kw)
    assert got[:2] == want[:2] and got[0] > 0
    if mode == "defer":
        assert got[1] > 0
    tiers = (("l1", "l2") if mode == "hier" else (None,))
    for tier in tiers:
        a = got[2] if tier is None else getattr(got[2], tier)
        b = want[2] if tier is None else getattr(want[2], tier)
        for f in ("keys", "fprint", "vals", "meta_a", "meta_b", "clock",
                  "expiry"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x.cpu(), y.cpu()), (tier, f)


def test_tick_restore_into_captured_graphs(cuda, tmp_path):
    """Crash mid-tick on the card: a fresh engine, its graphs captured,
    restored from the last committed checkpoint through its static
    buffers (the same addresses, the same graphs, no new capture), then
    replayed to the end: tokens and stats equal to an uninterrupted
    run."""
    from repro_torch.ckpt import manager
    from repro_torch.robust import faults, recovery
    from repro_torch.serve import engine as teng
    cfg, model = _tick_model(cuda)
    prompts = _tick_prompts(cfg.vocab_size, 6, seed=4)

    def build():
        eng = teng.Engine(cfg, model, teng.EngineConfig(**TICK_BASE),
                          device=cuda)
        for p in prompts:
            eng.submit(p, max_new=6)
        return eng

    ref = build()
    ref.run()
    eng = build()
    root = str(tmp_path / "ckpt")
    for _ in range(3):
        eng.step()
    recovery.save_engine(eng, root, 3)
    eng.step()
    faults.crashed_save(eng._state, root, 4)
    eng2 = teng.Engine(cfg, model, teng.EngineConfig(**TICK_BASE),
                       device=cuda)
    ptrs = [t.data_ptr() for _, t in manager.flatten(eng2._state)]
    graphs = dict(eng2._graphs)
    captures = teng.capture_counts()
    assert recovery.restore_engine(eng2, root) == 3
    assert [t.data_ptr() for _, t in manager.flatten(eng2._state)] == ptrs
    eng2.run()
    assert eng2._graphs == graphs and teng.capture_counts() == captures
    assert {r: q.generated for r, q in eng2.finished.items()} == \
        {r: q.generated for r, q in ref.finished.items()}
    assert eng2.stats == ref.stats


def test_ladder_on_the_card_raises_kernel_faults(cuda, monkeypatch):
    """On the card the healthy ladder lands on kernel 3 with no event; a
    kernel's exception reaches the caller (no ``torch-scan`` result) and a
    validator alarm on every rung ends at ``cuda-scan``."""
    from repro_torch.kernels import ops
    from repro_torch.robust import events, resilient_replay
    cfg = KWayConfig(num_sets=16, ways=4)
    tr = traces.generate("zipf", 2000, seed=3, catalog=256)
    chunks, en = router.pad_chunks(tr, 64)
    c0 = events.cursor()
    out = resilient_replay(cfg, chunks, en, device=cuda)
    assert out.attempts == (("cuda-resident", "ok"),)
    assert events.count(start=c0) == 0
    with pytest.raises(RuntimeError, match="last ladder rung 'cuda-scan'"):
        resilient_replay(cfg, chunks, en, device=cuda,
                         validate_fn=lambda st, sk: (False, "always bad"))

    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(ops, "replay_resident", boom)
    c0 = events.cursor()
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        resilient_replay(cfg, chunks, en, device=cuda)
    assert events.count(start=c0) == 0


# ---------------------------------------------------------------------------
# the eval sweep (repro_torch/eval)
# ---------------------------------------------------------------------------

def test_eval_timer_times_execution_not_dispatch(cuda):
    """``time_replay_percentiles`` blocks on a CUDA result: its samples
    cover the kernels' execution (tens of ms here), not the microseconds
    of their launch.  Dispatch and synced times are each the least of five
    calls."""
    from repro_torch.eval import timing
    x = torch.randn(4096, 4096, device=cuda) / 64.0

    def heavy():
        a = x
        for _ in range(8):
            a = a @ x
        return a

    timing.block(heavy())
    dispatch, synced = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = heavy()
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing.block(heavy())
        synced.append(time.perf_counter() - t0)
    del y
    st = timing.time_replay_percentiles(heavy, iters=5, warmup=1)
    assert st["p50"] >= 0.5 * min(synced), (st, dispatch, synced)
    if min(synced) > 20 * min(dispatch):
        assert st["p50"] > 5 * min(dispatch), (st, dispatch, synced)


@pytest.mark.parametrize("assoc,adm", [("k4", None), ("sampled4", "tl"),
                                       ("full", "tl"), ("k8", None)])
def test_eval_group_graph_equals_eager(cuda, assoc, adm):
    """The torch group's CUDA-graph replay equals the same step run eagerly
    on the card and the group on the CPU, lane for lane."""
    from repro_torch.eval import runner
    s, k, sample = runner.assoc_shape(assoc, 64)
    tl = admission.for_capacity(64) if adm else None
    trs = np.stack([traces.generate(f, 700, seed=sd)
                    for f in ("zipf", "oltp_mix") for sd in (1, 2)] * 3)[:10]
    pidx = [p % 5 for p in range(10)]

    def run(dev, graph):
        tc = hashing.key_tensor(trs, dev)
        pi = torch.tensor(pidx, dtype=torch.int32, device=dev)
        if graph:
            return runner._replay_group_torch(s, k, sample, runner.HASH_SEED,
                                              tl, pi, tc).cpu()
        g = runner._Group(s, k, sample, runner.HASH_SEED, tl, pi, tc)
        for _ in range(tc.shape[1]):
            g.step()
        return g.hits.cpu()

    runner.reset_capture_counts()
    graphed = run(cuda, True)
    assert sum(runner.capture_counts().values()) == 1
    assert torch.equal(graphed, run(cuda, False))
    assert torch.equal(graphed, run(torch.device("cpu"), False))


@pytest.mark.parametrize("adm", ["none", "tinylfu"])
def test_eval_cuda_point_is_one_kernel3_launch(cuda, adm):
    from repro_torch.eval import runner
    spec = runner.HitRatioSpec(families=("zipf",), policies=(Policy.LFU,),
                               assoc=("k8",), backends=("cuda", "torch"),
                               admissions=(adm,), capacity=256, n=2000,
                               seeds=(4,))
    krp.reset_trace_counts()
    recs, _ = runner.run_hit_ratio_sweep(spec, device=cuda)
    assert krp.launches("tinylfu" if adm == "tinylfu" else "flat") == 1
    assert sum(krp.trace_counts().values()) == 1
    by = {r["backend"]: r["value"] for r in recs}
    assert by["cuda"] == by["torch"]


# ---------------------------------------------------------------------------
# every model family and the sampler on the card
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("mixtral-8x22b", "dbrx-132b", "hymba-1.5b", "internvl2-2b",
                "seamless-m4t-large-v2", "stablelm-3b", "gemma2-2b",
                "minicpm-2b", "deepseek-7b", "mamba2-130m")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """The smoke config's ``forward`` (with its frontend stubs) and three
    ``decode_step``s on the card, logits within 3e-2 of the same model on
    the CPU (bf16 products sum in another order there)."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get(arch).smoke
    cpu = torch.device("cpu")
    model = lm.init_params(cfg, seed=4, device=cpu)
    r = np.random.default_rng(5)
    b, s = 2, 16
    kw, s_tok = {}, s
    if cfg.frontend == "patch":
        s_tok -= cfg.frontend_len
        kw["prefix_embeds"] = torch.from_numpy(r.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)) * 0.02).bfloat16()
    if cfg.enc_layers:
        s_tok //= 2
        kw["enc_embeds"] = torch.from_numpy(r.standard_normal(
            (b, s - s_tok, cfg.d_model)) * 0.02).bfloat16()
    toks = torch.from_numpy(r.integers(2, cfg.vocab_size, (b, s_tok)))
    outs = []
    for dev in (cpu, cuda):
        m = model.to(dev)
        logits = [lm.forward(cfg, m, toks.to(dev),
                             **{k: v.to(dev) for k, v in kw.items()})]
        cache = lm.init_cache(cfg, b, 32, device=dev)
        for i in range(3):
            step, cache = lm.decode_step(
                cfg, m, toks[:, i].to(dev),
                torch.full((b,), i, dtype=torch.int32, device=dev), cache)
            logits.append(step)
        outs.append([t.float().cpu() for t in logits])
    for want, got in zip(*outs):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


def test_sampler_bits_on_the_card_equal_the_cpu(cuda):
    """The threefry words, uniforms and sampled tokens on the card equal
    the CPU's (the draw is integer work; the tokens come from the same
    uniforms and logits), with the step as a device counter."""
    from repro_torch.core import prng
    from repro_torch.serve import engine as teng
    for step in (0, 7, 2**31 - 1):
        keys = [prng.fold_in(prng.prng_key(3), torch.tensor(
            step, dtype=torch.int32, device=d)) for d in ("cpu", cuda)]
        assert torch.equal(keys[1].cpu(), keys[0])
        assert torch.equal(prng.random_bits(keys[1], (8, 1000)).cpu(),
                           prng.random_bits(keys[0], (8, 1000)))
        assert torch.equal(prng.uniform(keys[1], (8, 1000)).cpu(),
                           prng.uniform(keys[0], (8, 1000)))
    ecfg = teng.EngineConfig(temperature=0.8, sample_seed=3)
    r = np.random.default_rng(6)
    for step in range(16):
        logits = torch.from_numpy((r.standard_normal((8, 512)) * 3).astype(
            np.float32))
        want = teng._sample_next(ecfg, logits, step)
        got = teng._sample_next(ecfg, logits.to(cuda), torch.tensor(
            step, dtype=torch.int32, device=cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, sample_seed=3,
                                             decode_block=4)],
                         ids=["greedy", "sampled-burst"])
def test_moe_tick_on_the_card_matches_the_host_loop(cuda, kw):
    """mixtral's smoke config (``moe_ff_shards=2``) served by the tick's
    CUDA graphs (the MoE dispatch captured: no host sync) and by the host
    loop on the card: stats, hit ratio, token counts and prefix hits equal,
    and the tokens by ``chip_smoke.py``'s rule (equal, or a bf16 tie at the
    first divergence in the scores the host loop drew from), one capture
    per kind."""
    import dataclasses
    import os
    import sys
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import engine as teng
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    cfg = dataclasses.replace(configs.get("mixtral-8x22b").smoke,
                              moe_ff_shards=2)
    model = lm.init_params(cfg, seed=0, device=cuda)
    prompts = _tick_prompts(cfg.vocab_size, 9, seed=3)
    teng.reset_capture_counts()
    runs, rec = {}, chip_smoke.SampleRecorder()
    for jitted in (True, False):
        eng = teng.Engine(cfg, model, teng.EngineConfig(
            **dict(TICK_BASE, jitted=jitted, **kw)), device=cuda)
        for p in prompts:
            eng.submit(p, max_new=6)
        if jitted:
            fin = eng.run()
        else:          # the host loop, its logits recorded
            rec.attach(eng)
            with rec:
                fin = eng.run()
        runs[jitted] = (eng.stats, eng.hit_ratio(), {
            rid: (r.generated, r.pages, r.prefix_hits)
            for rid, r in fin.items()})
    assert all(v == 1 for v in teng.capture_counts().values())
    (tst, thr, treqs), (hst, hhr, hreqs) = runs[True], runs[False]
    assert (tst, thr) == (hst, hhr)
    assert sorted(treqs) == sorted(hreqs) == list(range(len(prompts)))
    chip_smoke.check_tick_tokens(rec, hreqs, {
        rid: (toks, hits) for rid, (toks, _, hits) in treqs.items()})


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

def _train_steps(arch, dev, steps=3):
    """``steps`` ``make_train_step`` steps of ``arch``'s smoke config from
    seed-0 weights and the pipeline's batches on ``dev`` -> (losses, the
    step-1 gradients by name)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import (DataConfig, DataState,
                                           SyntheticPipeline)
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    cfg = configs.get(arch).smoke
    args = train.parse(["--arch", arch, "--smoke", "--batch", "2", "--seq",
                        "32"])
    model = lm.init_params(cfg, seed=0, device="cpu").to(dev)
    state = adamw.init(model)
    step_fn = tstep.make_train_step(cfg, tstep.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, total_steps=10)))
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=2))
    ds, losses, grads = DataState(), [], None
    for _ in range(steps):
        batch = train.make_batch(cfg, args, *pipe.batch(ds), dev)
        ds = pipe.advance(ds)
        model, state, m = step_fn(model, state, batch)
        losses.append(float(m["loss"]))
        if grads is None:
            grads = {n: None if p.grad is None else p.grad.float().cpu()
                     for n, p in model.named_parameters()}
    return losses, grads


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Three train steps on the card against the same steps on the CPU:
    each loss within 1e-3 relative, every step-1 gradient leaf within 3e-2
    relative L2 (None on both sides where the loss does not reach)."""
    want_losses, want_grads = _train_steps(arch, torch.device("cpu"))
    got_losses, got_grads = _train_steps(arch, cuda)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert got_grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        got = got_grads[name]
        assert (got is None) == (want is None), name
        if want is not None:
            den = float(torch.linalg.vector_norm(want))
            err = float(torch.linalg.vector_norm(got - want))
            assert err <= 3e-2 * den, (arch, name, err / max(den, 1e-30))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_gradients_on_the_card(cuda, arch, monkeypatch):
    """The loss and gradients of one batch on the card with remat (every
    block checkpointed, counted) against the same without: the same loss,
    every gradient leaf within 3e-2 relative L2 (the card-vs-CPU
    tolerance; equal kernels on equal inputs give equal values)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, DataState, \
        SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    cfg = configs.get(arch).smoke
    args = train.parse(["--arch", arch, "--smoke", "--batch", "2", "--seq",
                        "32"])
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=2))
    batch = train.make_batch(cfg, args, *pipe.batch(DataState()), cuda)
    entered, real = [], lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: (
        entered.append(fn), real(fn, *a, **kw))[1])
    runs = []
    for remat in (True, False):
        model = lm.init_params(cfg, seed=0, device="cpu").to(cuda)
        model.requires_grad_(True)
        loss = tstep.make_loss_fn(cfg, tstep.TrainConfig(remat=remat))(
            model, batch)
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in
                                            model.named_parameters()}))
    assert len(entered) == cfg.num_layers + cfg.enc_layers
    (la, ga), (lb, gb) = runs
    assert la == lb, (arch, la, lb)
    for name, want in gb.items():
        assert (ga[name] is None) == (want is None), name
        if want is not None:
            den = float(torch.linalg.vector_norm(want.float()))
            err = float(torch.linalg.vector_norm(ga[name].float()
                                                 - want.float()))
            assert err <= 3e-2 * den, (arch, name, err / max(den, 1e-30))


def test_train_launcher_resumes_on_the_card(cuda, tmp_path):
    """mamba2-130m smoke on the card (the launcher's default device): 6
    steps with a checkpoint every 3, then a resume to 10, the data cursor
    restored and every loss within 1e-3 relative of an uninterrupted run
    (the card's gradient sums need not repeat their order, so not bit for
    bit)."""
    from repro_torch.ckpt import manager as ckpt
    from repro_torch.launch import train
    base = ["--arch", "mamba2-130m", "--smoke", "--batch", "2", "--seq",
            "32", "--schedule", "const", "--ckpt-every", "3"]
    d = str(tmp_path / "run")
    first = train.run(train.parse(base + ["--steps", "6", "--ckpt-dir", d]))
    assert ckpt.latest_step(d) == 6 and first.data_step == 6
    assert next(first.model.parameters()).device.type == "cuda"
    rest = train.run(train.parse(base + ["--steps", "10", "--ckpt-dir", d]))
    assert (rest.start_step, rest.data_step) == (6, 10)
    assert ckpt.latest_step(d) == 10
    whole = train.run(train.parse(base + ["--steps", "10"]))
    np.testing.assert_allclose(first.losses + rest.losses, whole.losses,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# mesh execution on one card (a one-rank NCCL group)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group(cuda):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.ensure_group(1, "cuda")
    yield mesh_lib
    dist.destroy_process_group()


@pytest.mark.parametrize("tinylfu", [False, True])
def test_sharded_cache_one_device_mesh_equals_no_mesh(one_rank_group, cuda,
                                                      tinylfu):
    """``ShardedCache`` on a one-device ``sets`` mesh (kernel 2, and kernel
    1 under TinyLFU) against ``mesh=None``: every chunk's outputs and the
    final lanes, bit for bit."""
    from repro_torch.core.sharded import ShardedCache, ShardedConfig

    mesh = one_rank_group.make_mesh((1,), ("sets",), "cuda")
    cfg = ShardedConfig(cache=KWayConfig(num_sets=256, ways=8,
                                         policy=Policy.LRU), num_shards=1)
    tl = admission.for_capacity(2048) if tinylfu else None
    tr = traces.generate("zipf", 64 * 40, seed=3, catalog=20000)
    runs = []
    for m in (mesh, None):
        sc = ShardedCache(cfg, m, device=cuda)
        st = sc.init()
        sk = sc.init_sketches(tl) if tl is not None else None
        outs = []
        for c in range(40):
            keys = tr[c * 64:(c + 1) * 64]
            kw = {} if tl is None else {"tinylfu": tl, "sketches": sk}
            st, *o = sc.access(st, keys, keys.astype(np.int32), **kw)
            if tl is not None:
                sk = o.pop()
            outs.append([x.cpu() for x in o])
        runs.append((outs, kway.state_to_numpy(st)))
    (a, sa), (b, sb) = runs
    for c, (x, y) in enumerate(zip(a, b)):
        for i, (u, v) in enumerate(zip(x, y)):
            assert torch.equal(u, v), (c, i)
    for leaf in sa:
        np.testing.assert_array_equal(sa[leaf], sb[leaf], err_msg=leaf)


def test_train_one_device_mesh_equals_no_mesh(one_rank_group, cuda):
    """``launch.train.run`` through ``make_dev_mesh(1, 1)`` (DTensor
    parameters, every placement replicated) against the plain one-device
    run: equal losses (deterministic algorithms, so every backward op adds
    in one order)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import train

    mesh = one_rank_group.make_dev_mesh(1, 1)
    args = ["--arch", "gemma2-2b", "--smoke", "--batch", "2", "--seq", "32",
            "--steps", "3", "--lr", "1e-3"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        on = train.run(train.parse(args), mesh=mesh)
        off = train.run(train.parse(args))
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(isinstance(p, DTensor) for p in on.model.parameters())
    np.testing.assert_allclose(on.losses, off.losses, rtol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer's pass over every leaf (csrc/adamw.cu)
# ---------------------------------------------------------------------------

#: leaf sizes: odd, below one vector, zero, one past a chunk, and a few
#: chunks' worth (the fixed grid strides over them)
ADAMW_SIZES = [1, 3, 4, 1027, 0, kadamw.CHUNK + 5, 33, 3 * 2**20 + 7]


def _adamw_leaves(dev, seed=0, gscale=1e-2):
    """(grads, m, v, master, params) on ``dev``: bf16 and float32
    gradients and parameters mixed, one gradient None, one parameter
    None."""
    rng = np.random.default_rng(seed)
    n = len(ADAMW_SIZES)
    gdt = [torch.bfloat16, torch.float32, None] + [torch.bfloat16] * (n - 3)
    pdt = [torch.bfloat16, torch.float32, torch.bfloat16, None] \
        + [torch.bfloat16, torch.float32] * n

    def f32(k, s=1.0):
        return torch.from_numpy(
            rng.standard_normal(k).astype(np.float32) * s).to(dev)

    grads = [None if d is None else f32(k, gscale).to(d)
             for k, d in zip(ADAMW_SIZES, gdt)]
    m = [f32(k, 1e-3) for k in ADAMW_SIZES]
    v = [f32(k, 1e-3).abs() for k in ADAMW_SIZES]
    master = [f32(k) for k in ADAMW_SIZES]
    params = [None if d is None else w.to(d) for w, d in zip(master, pdt)]
    return grads, m, v, master, params


def _clone(leaves):
    return tuple([None if t is None else t.clone() for t in ts]
                 for ts in leaves)


def _adamw_scalars(dev, scale):
    return [scale] + [torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in (3e-3, 0.1, 0.05)]


ADAMW_HYPER = (0.9, 0.95, 1e-8, 0.1)


def _clip_scale(sq, clip):
    gnorm = torch.sqrt(sq)
    return torch.clamp(torch.full_like(gnorm, clip) / (gnorm + 1e-9),
                       max=1.0)


def test_adamw_kernel_equals_plain_clip_inactive(cuda):
    """Scale exactly 1.0: m, v, master and every parameter equal to the
    plain version's bit for bit; one launch."""
    leaves = _adamw_leaves(cuda)
    plain = _clone(leaves)
    scale = _clip_scale(kadamw.sumsq([g for g in leaves[0]
                                      if g is not None]), 1e6)
    assert float(scale) == 1.0
    before = kadamw.LAUNCHES["adamw"]
    kadamw.adamw_step_(*leaves, *_adamw_scalars(cuda, scale), *ADAMW_HYPER)
    kadamw.adamw_step_plain(*plain, *_adamw_scalars(cuda, scale),
                            *ADAMW_HYPER)
    torch.cuda.synchronize()
    assert kadamw.LAUNCHES["adamw"] == before + 1
    for k, (xs, ys) in enumerate(zip(leaves[1:], plain[1:])):
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), (k, i, ADAMW_SIZES[i])


def test_adamw_kernel_near_plain_clip_active(cuda):
    """Each side's own norm (the kernel's and the plain sum), the clip
    active: every state leaf within 1e-6 relative (absolute against the
    leaf's largest value), the parameters within one bf16 ulp."""
    leaves = _adamw_leaves(cuda, gscale=1.0)
    plain = _clone(leaves)
    gk = [g for g in leaves[0] if g is not None]
    sk = _clip_scale(kadamw.sumsq(gk), 1.0)
    sp = _clip_scale(kadamw.sumsq_plain(gk), 1.0)
    assert float(sk) < 1.0
    np.testing.assert_allclose(float(sk), float(sp), rtol=1e-6)
    kadamw.adamw_step_(*leaves, *_adamw_scalars(cuda, sk), *ADAMW_HYPER)
    kadamw.adamw_step_plain(*plain, *_adamw_scalars(cuda, sp), *ADAMW_HYPER)
    for xs, ys in zip(leaves[1:4], plain[1:4]):
        for x, y in zip(xs, ys):
            if x.numel():
                np.testing.assert_allclose(
                    x.cpu().numpy(), y.cpu().numpy(), rtol=1e-6,
                    atol=1e-6 * float(y.abs().max()))
    for x, y in zip(leaves[4], plain[4]):
        if x is not None and x.numel():
            diff = (x.float() - y.float()).abs()
            assert float((diff - 2 ** -7 * y.float().abs()).max()) <= 0


def test_adamw_sumsq_against_float64_and_repeatable(cuda):
    """The norm's pass within 1e-6 of a float64 sum of the float32
    squares, the same bits over two runs, zero for zero-size leaves only."""
    grads = [g for g in _adamw_leaves(cuda, seed=3, gscale=1.0)[0]
             if g is not None]
    want = sum(float((g.double() ** 2).sum()) for g in grads)
    a, b = kadamw.sumsq(grads), kadamw.sumsq(grads)
    assert a.dtype == torch.float32 and a.shape == ()
    assert torch.equal(a, b)
    assert abs(float(a) - want) <= 1e-6 * want, (float(a), want)
    empty = [torch.empty(0, dtype=torch.bfloat16, device=cuda)]
    assert float(kadamw.sumsq(empty)) == 0.0


def test_adamw_kernel_rejects_bad_leaves(cuda):
    """Non-contiguous, mismatched or wrongly typed leaves raise; nothing
    falls back to the plain version."""
    grads, m, v, master, params = _adamw_leaves(cuda)
    sc = _adamw_scalars(cuda, torch.ones((), device=cuda))
    wide = torch.zeros(2 * master[3].numel(), device=cuda)
    bad = [
        (grads[:3] + [wide[::2]] + grads[4:], m, v, master, params),
        (grads, m, v, [master[0].double()] + master[1:], params),
        (grads, m, [v[0][:0]] + v[1:], master, params),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            kadamw.adamw_step_(*case, *sc, *ADAMW_HYPER)
    with pytest.raises(ValueError):
        kadamw.sumsq([wide[::2]])
    with pytest.raises(ValueError):
        kadamw.sumsq([grads[0].half()])


def test_adamw_update_on_the_card(cuda):
    """``adamw.update`` on a smoke model on the card: one launch of each
    pass, no host sync, three steps within 1e-5 of the same steps on the
    CPU (whose norm sums in another order)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = configs.get("gemma2-2b").smoke
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, grad_clip=0.05)
    rng = np.random.default_rng(1)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model = lm.init_params(cfg, seed=0, device="cpu").to(dev)
        state = adamw.init(model)
        launches = dict(kadamw.LAUNCHES)
        for step in range(3):
            grads = {n: torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)).to(dev, p.dtype)
                for n, p in model.named_parameters()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, _, metrics = adamw.update(ocfg, grads, state, model)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if dev.type == "cuda":
            assert kadamw.LAUNCHES["adamw"] == launches["adamw"] + 3
            assert kadamw.LAUNCHES["adamw_sumsq"] == \
                launches["adamw_sumsq"] + 3
        rng = np.random.default_rng(1)
        runs.append((float(metrics["grad_norm"]),
                     {n: t.cpu() for n, t in state["master"].items()}))
    (na, wa), (nb, wb) = runs
    np.testing.assert_allclose(na, nb, rtol=1e-5)
    for name in wa:
        np.testing.assert_allclose(wa[name].numpy(), wb[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
