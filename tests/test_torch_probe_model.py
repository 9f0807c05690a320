"""Kernels 1 and 2's algorithms, on the CPU.

``csrc/kway_probe.cu`` cannot run here, so its algorithms are modelled
lane by lane in Python and held, bit for bit, to the plain versions
(``repro_torch.kernels.ref``), which ``tests/test_torch_kernels.py`` holds
to the reference:

  * the route inside the kernels: sanitize, ``hash_u32`` set index, the
    times ``clock + i`` and ``clock + B + i`` with int32 wrap;
  * a lane group's probe: the lowest matching way of the row, as a ballot
    and ``__ffs`` over ways ``gl + j*G``;
  * the victim order as the count of ways that sort before each way (a
    lower float32 score, or a tie at a lower way), empty ways at -inf;
  * kernel 2's set partition: CTA c takes the queries whose set is c mod
    C (listed in any order), its scratch region starts at 15 x (queries of
    the CTAs before it) when they outnumber the 512 that shared memory
    lists, it groups its queries by set in a hash table of H >= 2n slots
    (in shared memory at most 6 x 512 ints), and one
    lane group per set applies the set's live hits to its row (in any
    order: the model walks each group in a shuffled order) before scoring
    every query of the set.

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hashing, kway
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.kernels import kway_probe as kp
from repro_torch.kernels import ref as kref

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
EMPTY = -1
NEG_INF = np.float32(-3.0e38)
SCRATCH_PER_QUERY = 15
SMEM_QUERIES = 512


def _i32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _hash(k, seed):
    return hashing.hash_u32_int(k & M32, seed)


def _score(policy, key, a, b, now):
    if policy == Policy.RANDOM:
        return np.float32(_hash((key ^ now) & M32, 0xBADA))
    if policy == Policy.HYPERBOLIC:
        age = np.float32(np.float32(_i32(now - b)) + np.float32(1.0))
        return np.float32(np.float32(a) / age)
    return np.float32(a)


def _ctas(b, s):
    """Kernel 2's grid: about 8 queries a CTA, at most 256, at most S."""
    c = 1
    while c * 2 <= b // 8 and c * 2 <= 256 and c * 2 <= s:
        c *= 2
    return c


class _Lanes:
    """A lane group of G lanes holding one row: lane gl has ways gl + j*G."""

    def __init__(self, st, row, ways):
        self.g = 1 << max(0, (min(ways, 32) - 1).bit_length())
        self.j = -(-ways // self.g)
        self.ways = ways
        self.key = st["keys"][row].tolist()
        self.fp = st["fprint"][row].tolist()
        self.a = st["meta_a"][row].tolist()
        self.b = st["meta_b"][row].tolist()

    def probe(self, qk):
        """The lowest matching way: ballot j = 0, 1, ... then __ffs."""
        qfp = _hash(qk, 0xF19E) & 0xFFFF
        for j in range(self.j):
            bal = 0
            for gl in range(self.g):
                w = j * self.g + gl
                if (w < self.ways and self.key[w] != EMPTY
                        and self.fp[w] == qfp and self.key[w] == qk):
                    bal |= 1 << gl
            if bal:
                return j * self.g + (bal & -bal).bit_length() - 1
        return -1

    def order(self, policy, now):
        """pos[w]: the count of ways v with sc[v] < sc[w], or equal and
        v < w -> the order, worst victim first."""
        sc = [NEG_INF if self.key[w] == EMPTY
              else _score(policy, self.key[w], self.a[w], self.b[w], now)
              for w in range(self.ways)]
        out = [0] * self.ways
        for w in range(self.ways):
            pos = sum(1 for v in range(self.ways)
                      if sc[v] < sc[w] or (sc[v] == sc[w] and v < w))
            out[pos] = w
        return out


def _route(raw, s, seed):
    qk = [-2 if k == EMPTY else k for k in raw]
    return qk, [_hash(k, seed) & (s - 1) for k in qk]


def probe_model(st, raw, clock, s, seed, policy):
    """Kernel 1, one lane group per query."""
    qk, sets = _route(raw, s, seed)
    ways = st["keys"].shape[1]
    hit, way, vway, vkey, order = [], [], [], [], []
    for i in range(len(raw)):
        r = _Lanes(st, sets[i], ways)
        w0 = r.probe(qk[i])
        hit.append(w0 >= 0)
        way.append(max(w0, 0))
        o = r.order(policy, _i32(clock + i))
        order.append(o)
        vway.append(o[0])
        vkey.append(r.key[o[0]])
    return qk, sets, hit, way, vway, vkey, order


def fused_model(st, raw, clock, en, s, seed, policy, rng):
    """Kernel 2: the set partition over CTAs, the hash-table grouping, and
    each set's lane group (hits applied in a shuffled order)."""
    b = len(raw)
    ways = st["keys"].shape[1]
    qk, sets = _route(raw, s, seed)
    c_n = _ctas(b, s)
    hit, way = [None] * b, [None] * b
    order = [None] * b
    regions = []
    for c in range(c_n):
        mine = [i for i in range(b) if sets[i] % c_n == c]
        n_lt = sum(1 for i in range(b) if sets[i] % c_n < c)
        n = len(mine)
        if n == 0:
            continue
        h_n = 2
        while h_n < 2 * n:
            h_n *= 2
        if n > SMEM_QUERIES:  # the CTA's region of the global scratch
            assert 3 * h_n + 3 * n <= SCRATCH_PER_QUERY * n
            regions.append((SCRATCH_PER_QUERY * n_lt,
                            SCRATCH_PER_QUERY * (n_lt + n)))
        else:                 # the table in shared memory, before the list
            assert 3 * h_n <= 6 * SMEM_QUERIES
        # the scan lists the CTA's queries in the order its atomics land
        mine = [mine[k] for k in rng.permutation(n)]
        tab = [None] * h_n
        groups = {}
        for i in mine:               # linear probing from hash_u32(set)
            h = _hash(sets[i], 0x5E75) & (h_n - 1)
            while tab[h] is not None and tab[h] != sets[i]:
                h = (h + 1) & (h_n - 1)
            tab[h] = sets[i]
            groups.setdefault(h, []).append(i)
        for h, qs in groups.items():
            assert len({sets[i] for i in qs}) == 1
            qs = [qs[k] for k in rng.permutation(len(qs))]
            r = _Lanes(st, tab[h], ways)
            for i in qs:             # the set's live hits, on meta_a
                w0 = r.probe(qk[i])
                hit[i], way[i] = w0 >= 0, max(w0, 0)
                if w0 >= 0 and (en is None or en[i]):
                    if policy == Policy.LRU:
                        r.a[w0] = max(r.a[w0], _i32(clock + i))
                    elif policy in (Policy.LFU, Policy.HYPERBOLIC):
                        r.a[w0] = _i32(r.a[w0] + 1)
            for i in qs:
                order[i] = r.order(policy, _i32(clock + b + i))
    regions.sort()
    assert all(e <= s2 for (_, e), (s2, _) in zip(regions, regions[1:]))
    assert all(e <= SCRATCH_PER_QUERY * b for _, e in regions)
    assert None not in hit
    return qk, sets, hit, way, order


def _state(s, ways, seed):
    """A state filled by a short replay on the torch twin, as numpy."""
    cfg = KWayConfig(num_sets=s, ways=ways, policy=Policy.LFU)
    st = kway.make_cache(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(6):
        keys = hashing.key_tensor(rng.integers(0, 4 * s * ways, 64), "cpu")
        st, *_ = kway.access(cfg, st, keys, keys)
    st = kway.state_to_numpy(st)
    out = {f: st[f].view(np.int32) for f in
           ("keys", "fprint", "meta_a", "meta_b")}
    out["clock"] = int(st["clock"])
    return out


def _raw(st, b, rng, one_set=None):
    """Raw keys: resident keys, duplicates, EMPTY; or keys of one set."""
    keys = st["keys"].reshape(-1)
    if one_set is not None:
        pool = np.concatenate([st["keys"][0][st["keys"][0] != EMPTY],
                               one_set])
        return [int(k) for k in pool[rng.integers(0, len(pool), b)]]
    raw = rng.integers(0, 2**31, b).astype(np.int64)
    take = rng.random(b) < 0.5
    raw[take] = keys[rng.integers(0, len(keys), int(take.sum()))]
    raw[: b // 5] = raw[0]
    raw[rng.random(b) < 0.05] = EMPTY
    return [int(k) for k in raw]


def _one_set_keys(s, seed):
    cand = np.arange(1, 64 * s, dtype=np.int64)
    sets = np.array([_hash(int(k), seed) & (s - 1) for k in cand])
    return cand[sets == 0]


def _tensors(st):
    return [torch.from_numpy(st[f].copy()) for f in
            ("keys", "fprint", "meta_a", "meta_b")]


def _check(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, dtype=g.numpy()
                                                            .dtype),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("ways", [1, 8, 33])
def test_probe_model_matches_plain(policy, ways):
    """Kernel 1's lane-group probe and count-of-lower-or-tied order ==
    ``kway_probe_ref`` (hit, way, victim, order), B 1 and 97."""
    s, seed = 16, 0x51CA
    st = _state(s, ways, seed=ways)
    rng = np.random.default_rng(ways)
    for b in (1, 97):
        raw = _raw(st, b, rng)
        clock = torch.tensor(st["clock"], dtype=torch.int32)
        want = kref.kway_probe_ref(
            *_tensors(st), torch.tensor(raw, dtype=torch.int32), clock,
            num_sets=s, seed=seed, policy=policy, full_order=True)
        _check(want, probe_model(st, raw, st["clock"], s, seed, policy))


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("ways,s,b", [(1, 16, 97), (8, 16, 300),
                                      (33, 4, 64), (8, 1, 40), (2, 64, 1),
                                      (4, 8, "one-set")])
def test_fused_model_matches_plain(policy, ways, s, b):
    """Kernel 2's partition, grouping and per-set hit application ==
    ``kway_fused_probe_ref``: many CTAs (B 300: 32), one set (S 1), one
    query, and a batch of one set (600 queries, more than a CTA groups in
    shared memory), with an enable mask and with none."""
    seed = 0x51CA
    st = _state(s, ways, seed=ways + s)
    rng = np.random.default_rng(ways + s)
    if b == "one-set":
        raw = _raw(st, 600, rng, one_set=_one_set_keys(s, seed))
    else:
        raw = _raw(st, b, rng)
    n = len(raw)
    clock = torch.tensor(st["clock"], dtype=torch.int32)
    for en in (rng.random(n) < 0.7, None):
        want = kref.kway_fused_probe_ref(
            *_tensors(st), torch.tensor(raw, dtype=torch.int32), clock,
            None if en is None else torch.from_numpy(en), num_sets=s,
            seed=seed, policy=policy)
        _check(want, fused_model(st, raw, st["clock"], en, s, seed, policy,
                                 rng))


@pytest.mark.parametrize("mode", ["hits", "victim", "order", "fused"])
@pytest.mark.parametrize("b,ways", [(1, 1), (7, 8), (257, 33)])
def test_output_buffer_layout(mode, b, ways):
    """The wrappers' views of their one int32 buffer: disjoint, inside it,
    int64 regions 8-byte aligned, in the plain versions' dtypes and
    shapes."""
    m = ["hits", "victim", "order", "fused"].index(mode)
    words = kp._words(b, ways, m)
    buf = torch.zeros(words, dtype=torch.int32)
    outs = kp._views(buf, b, ways, m)
    dtypes = [torch.int32, torch.int64, torch.bool, torch.int64]
    shapes = [(b,)] * 4
    if mode in ("victim", "order"):
        dtypes += [torch.int64, torch.int32]
        shapes += [(b,)] * 2
    if mode in ("order", "fused"):
        dtypes.append(torch.int32)
        shapes.append((b, ways))
    assert [o.dtype for o in outs] == dtypes
    assert [tuple(o.shape) for o in outs] == shapes
    spans = []
    base = buf.data_ptr()
    for o in outs:
        lo = o.data_ptr() - base
        spans.append((lo, lo + o.numel() * o.element_size()))
        if o.dtype == torch.int64:
            assert lo % 8 == 0
    # the C layout, in int32 words: sets [2B], way [2B], vway [2B], qk [B],
    # vkey [B], order [B * ways], hit bytes
    victims = mode in ("victim", "order")
    at = {"sets": 0, "way": 2 * b}
    o = 6 * b if victims else 4 * b
    if victims:
        at["vway"] = 4 * b
    at["qk"] = o
    o += b
    if victims:
        at["vkey"] = o
        o += b
    if mode in ("order", "fused"):
        at["order"] = o
        o += b * ways
    at["hit"] = o
    names = ["qk", "sets", "hit", "way"] + ["vway", "vkey"] * victims \
        + ["order"] * (mode in ("order", "fused"))
    assert [lo for lo, _ in spans] == [4 * at[n] for n in names]
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))
    scratch = kp.FUSED_SCRATCH * b * 4 if mode == "fused" else 0
    assert spans[-1][1] <= 4 * words - scratch
