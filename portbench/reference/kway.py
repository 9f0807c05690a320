"""Plain k-way set-associative LRU cache: the yardstick of the cache cells
and of the serving engine's prefix cache.

A frozen, independent statement of the semantics that the cache under test
promises (arXiv:2109.03021's k-way cache with the batched, deterministic
conflict resolution of the repository's ``access``):

* keys are uint32, carried as int32 bit patterns; 0xFFFFFFFF marks an empty
  way, so a request for it is folded onto 0xFFFFFFFE first;
* a key lives in set ``hash(key, 0x51CA) & (S - 1)`` and carries the
  fingerprint ``hash(key, 0xF19E) & 0xFFFF`` (murmur3's finalizer over
  ``(key + seed * 0x9E3779B1) * 0x85EBCA77``, all mod 2**32);
* a batch of B requests at clock c is one step: lane i probes at time
  ``c + i``, a hit stamps that time on its way (the latest stamp wins), and
  the misses then insert at ``c + B + i``: the first lane of each missing
  key inserts, the r-th inserting lane of a set takes the r-th entry of the
  set's victim order (empty ways first, then ascending float32 stamp, ties
  to the lower way), at most ``ways`` inserts a set; the clock ends at
  ``c + 2B``;
* a hit answers the stored value, a miss the request's own value, or with
  ``slot_value`` the slot id ``set * ways + way`` it landed in (-1: none).

Everything here is plain torch on any device and numpy on the host; it
imports nothing of the program.  ``G`` independent caches advance side by
side (the replay cell's four traces).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

M32 = 0xFFFFFFFF
EMPTY = -1
SET_SEED = 0x51CA
FP_SEED = 0xF19E
_P1, _P2 = 0x9E3779B1, 0x85EBCA77
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
_I32_MIN = -(2**31)
#: the victim score of an empty way
_EMPTY_SCORE = -3.0e38


def _mulmod(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant in two
    16-bit halves, so no partial product passes 2**48."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash32(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """The seeded murmur3-finalizer hash of uint32 keys (any integer dtype,
    read as its low 32 bits) -> int64 in [0, 2**32)."""
    x = _mulmod((keys.long() + (seed * _P1 & M32)) & M32, _P2)
    x = x ^ (x >> 16)
    x = _mulmod(x, _C1)
    x = x ^ (x >> 13)
    x = _mulmod(x, _C2)
    return x ^ (x >> 16)


def fold(keys: torch.Tensor) -> torch.Tensor:
    """int32 key lanes with the empty marker folded onto 0xFFFFFFFE."""
    return torch.where(keys == EMPTY, torch.full_like(keys, -2), keys)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


@dataclasses.dataclass
class Cache:
    """G caches of S sets x W ways.  Each lane is a flat int32 buffer of
    G * S * W slots plus one scratch slot, which the lanes that write
    nothing write (so no step waits on the host); ``clock`` int64 [G]
    (wrapping as int32)."""

    buf: dict
    clock: torch.Tensor
    shape: tuple

    @property
    def sets(self) -> int:
        return self.shape[1]

    @property
    def ways(self) -> int:
        return self.shape[2]

    def lane(self, name: str) -> torch.Tensor:
        return self.buf[name][:-1].view(self.shape)

    def clone(self) -> "Cache":
        return Cache({k: v.clone() for k, v in self.buf.items()},
                     self.clock.clone(), self.shape)

    def lanes(self, g: int) -> dict:
        """Cache ``g``'s lanes as int32 [S, W] tensors, by the program's
        lane names (``meta_b`` is always zero under LRU)."""
        out = {f: self.lane(n)[g] for f, n in (
            ("keys", "keys"), ("fprint", "fprint"), ("vals", "vals"),
            ("meta_a", "stamp"))}
        out["meta_b"] = torch.zeros_like(out["meta_a"])
        return out

    def clock_of(self, g: int) -> int:
        return int(_wrap(self.clock[g]))


def empty(groups: int, sets: int, ways: int, device) -> Cache:
    if sets & (sets - 1):
        raise ValueError("the number of sets must be a power of two")
    n = groups * sets * ways + 1

    def full(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    return Cache({"keys": full(EMPTY), "fprint": full(0), "vals": full(0),
                  "stamp": full(0)},
                 torch.zeros(groups, dtype=torch.int64, device=device),
                 (groups, sets, ways))


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32."""
    return to_i32(x & M32)


def access(c: Cache, q: torch.Tensor, qv: torch.Tensor, en=None, *,
           slot_value: bool = False, batch_clock: bool = False):
    """One batched step of each cache, in place.  ``q`` int32 [G, B] raw
    keys, ``qv`` int32 [G, B] values, ``en`` bool [G, B] (None: all).
    ``batch_clock`` is the control, which breaks the LRU guarantee: every
    lane of the batch probes at ``c`` and inserts at ``c + B`` (recency
    kept per batch, not per request).  -> (hit bool [G, B], answer int32
    [G, B], evicted key int32 [G, B], evicted bool [G, B])."""
    g_n, b = q.shape
    s_n, w_n = c.sets, c.ways
    dev = q.device
    keys, fprint = c.lane("keys"), c.lane("fprint")
    vals, stamp = c.lane("vals"), c.lane("stamp")
    qs = fold(q.to(torch.int32))
    u = qs.long() & M32
    sets = hash32(u, SET_SEED) & (s_n - 1)
    fp = (hash32(u, FP_SEED) & 0xFFFF).to(torch.int32)
    en = torch.ones_like(qs, dtype=torch.bool) if en is None else en.bool()
    g = torch.arange(g_n, device=dev)[:, None].expand(g_n, b)
    lane = torch.arange(b, device=dev)

    row = keys[g, sets]                                     # [G, B, W]
    match = (row == qs[..., None]) & (fprint[g, sets] == fp[..., None]) \
        & (row != EMPTY)
    found = match.any(-1)
    way = torch.argmax(match.to(torch.int8), dim=-1)        # first match
    hit = found & en
    step = lane * (not batch_clock)
    t_get = _wrap(c.clock[:, None] + step)
    t_put = _wrap(c.clock[:, None] + b + step)

    answer = torch.where(hit, vals[g, sets, way], qv.to(torch.int32))
    # hit stamps: the latest time of the lanes that hit a way
    flat = ((g * s_n + sets) * w_n + way).reshape(-1)
    stamp.view(-1).scatter_reduce_(
        0, flat, torch.where(hit, t_get, _I32_MIN).reshape(-1), "amax")

    # victim order of each lane's set, after this batch's hit stamps
    score = torch.where(row == EMPTY, _EMPTY_SCORE,
                        stamp[g, sets].to(torch.float32))
    order = torch.argsort(score, dim=-1, stable=True)       # [G, B, W]

    # the first lane of each missing key inserts
    want = en & ~found
    big = g_n * (M32 + 1)
    ident = torch.where(want, g * (M32 + 1) + u, big + g * b + lane)
    s_key, perm = torch.sort((ident * (g_n * b) + g * b + lane).reshape(-1))
    s_id = s_key // (g_n * b)
    first_sorted = torch.ones_like(s_id, dtype=torch.bool)
    first_sorted[1:] = s_id[1:] != s_id[:-1]
    first = torch.empty_like(first_sorted).scatter_(0, perm, first_sorted)
    ins = want & first.view(g_n, b)

    # the r-th inserting lane of a set, in lane order, takes victim r
    gs = torch.where(ins, g * s_n + sets, g_n * s_n)
    s_key, perm = torch.sort((gs * b + lane).reshape(-1))
    s_set = s_key // b
    start = torch.searchsorted(s_set, s_set, right=False)
    rank_sorted = torch.arange(s_set.numel(), device=dev) - start
    rank = torch.empty_like(rank_sorted).scatter_(0, perm, rank_sorted)
    rank = rank.view(g_n, b)
    ins = ins & (rank < w_n)
    victim = torch.gather(order, -1,
                          rank.clamp(max=w_n - 1)[..., None])[..., 0]
    ev_key = keys[g, sets, victim]
    evicted = ins & (ev_key != EMPTY)

    slot = (sets * w_n + victim).to(torch.int32)
    if slot_value:
        answer = torch.where(hit, answer,
                             torch.where(ins, slot, torch.full_like(slot, -1)))
    stored = slot if slot_value else qv.to(torch.int32)
    # inserting lanes write their own slots (distinct: distinct ranks of
    # one set's order); the others write the scratch slot
    dest = torch.where(ins, (g * s_n + sets) * w_n + victim,
                       g_n * s_n * w_n).reshape(-1)
    for name, v in (("keys", qs), ("fprint", fp), ("vals", stored),
                    ("stamp", t_put)):
        c.buf[name].index_put_((dest,), v.reshape(-1))
    c.clock = (c.clock + 2 * b) & M32
    return hit, answer, ev_key, evicted


def replay(c: Cache, chunks: torch.Tensor, en=None, *,
           batch_clock: bool = False):
    """Replay ``chunks`` int32 [G, T, B] (payload = key) through the G
    caches, in place (``batch_clock``: the control) -> (hits int32 [G, T],
    evictions int32 [G, T])."""
    g_n, t_n, _ = chunks.shape
    hits = torch.zeros((g_n, t_n), dtype=torch.int32, device=chunks.device)
    evs = torch.zeros_like(hits)
    for t in range(t_n):
        e = None if en is None else en[:, t]
        hit, _, _, ev = access(c, chunks[:, t], chunks[:, t], e,
                               batch_clock=batch_clock)
        hits[:, t] = hit.sum(-1)
        evs[:, t] = ev.sum(-1)
    return hits, evs


# ---------------------------------------------------------------------------
# the serving engine's content keys
# ---------------------------------------------------------------------------

_FNV_OFFSET, _FNV_PRIME = 2166136261, 16777619


def prefix_block_keys(tokens, page: int) -> np.ndarray:
    """Content key of each full ``page``-token block of a prompt: FNV-1a
    over the block's tokens, XOR the block's 1-based index times
    0x9E3779B1, murmur3's finalizer, then the XOR of all blocks so far (so
    a key stands for the whole prefix); 0xFFFFFFFF becomes 1.  -> int32
    bit patterns [len // page]."""
    tokens = np.asarray(tokens, np.int64)
    n = len(tokens) // page
    h = np.full(n, _FNV_OFFSET, np.uint64)
    blocks = (tokens[:n * page].reshape(n, page) & M32).astype(np.uint64)
    for j in range(page):
        h = ((h ^ blocks[:, j]) * np.uint64(_FNV_PRIME)) & np.uint64(M32)
    salt = (np.arange(1, n + 1, dtype=np.uint64) * np.uint64(_P1)) \
        & np.uint64(M32)
    x = h ^ salt
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(_C1)) & np.uint64(M32)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(_C2)) & np.uint64(M32)
    x ^= x >> np.uint64(16)
    out = np.bitwise_xor.accumulate(x) if n else x
    out[out == M32] = 1
    return out.astype(np.uint32).view(np.int32)
