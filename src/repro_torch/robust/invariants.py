"""Structural invariants over cache and serving state, as tensor ops.

Counterpart of ``repro/robust/invariants.py``, with the same bit
catalogues and bitmap layout: a word per lane / slot / page whose bits name
the failed checks, plus an OR-reduced word, so a replay loop can carry
"anything wrong yet?" as one tensor without a host sync.  The host-side
``explain_*`` functions turn a report into strings naming set / way / slot
/ page and the violated invariant.  The bitmaps are int32 (the catalogues
use bits 0-9); the reference's are uint32 with the same values.

Invariants over ``KWayState`` (per lane): ``fprint_mismatch`` (soa only),
``empty_lane_dirty`` (an empty lane must be zeroed, and park
``NO_EXPIRY``), ``wrong_set``, ``dup_key_in_set``, ``meta_bounds`` (LRU /
FIFO timestamps in ``[0, clock)``, LFU counts in ``[1, clock]``, RANDOM
zero, HYPERBOLIC ``t0`` before ``clock``), ``vals_convention`` (``"key"``:
val == key for the replay paths, ``"slot"``: val == set*ways + way for the
serving engine), and on TTL states ``expired_hit`` (LRU / FIFO: a stamp at
or past the deadline) and, in ``expiry_mode="strict"``,
``expired_resident`` (a deadline at or before the clock).  Over a
``HierState``: both tiers in ``"lazy"`` expiry mode, plus
``double_resident`` (an L1 key also in its L2 home set).  Over the TinyLFU
sketch: ``additions`` in ``[0, sample)`` and ``popcount(door) <=
additions``.  Over the port's ``ServeState``: per slot, per private page,
NaN in the KV pools and the stat counters.  The port's pools carry one
sink page past the last real one, which is not a page: the NaN check reads
only the real pages, and page-table entries must name a real one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import NO_EXPIRY, KWayConfig, KWayState
from repro_torch.core.policies import Policy

# ---------------------------------------------------------------------------
# bit catalogues: explain_* and the chaos tests key off these names
# ---------------------------------------------------------------------------

CACHE_CHECKS = {
    0: "fprint_mismatch",
    1: "empty_lane_dirty",
    2: "wrong_set",
    3: "dup_key_in_set",
    4: "meta_bounds",
    5: "vals_convention",
    6: "expired_hit",
    7: "expired_resident",
    8: "double_resident",
}
CACHE_GLOBAL_CHECKS = {0: "clock_negative"}
SKETCH_CHECKS = {0: "sketch_additions_range", 1: "sketch_door_popcount"}
SLOT_CHECKS = {
    0: "pos_range",
    1: "page_accounting",
    2: "page_table_range",
    3: "gen_range",
    4: "dup_page_in_row",
}
PAGE_CHECKS = {
    0: "double_booked",
    1: "owner_mismatch",
    2: "owner_inactive",
    3: "owner_range",
}
SERVE_GLOBAL_CHECKS = {0: "nan_in_kv", 1: "counter_bounds"}

#: the reference's packed hierarchy rows: seven sections of 128 columns
#: (keys | fprint | vals | meta_a | meta_b | scalar mailbox | expiry)
ROW_LANES = 128
ROW_SECS = 7


def _bit(cond: torch.Tensor, i: int) -> torch.Tensor:
    return cond.to(torch.int32) << i


def or_reduce(bits: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of every element -> int32 [] (log2(n) folds, no host
    sync)."""
    x = bits.reshape(-1).to(torch.int32)
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=bits.device)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x[-1:]])
        half = x.numel() // 2
        x = x[:half] | x[half:]
    return x.reshape(())


@dataclasses.dataclass
class CacheReport:
    """Violation bitmap over one ``KWayState``."""

    lane_bits: torch.Tensor    # int32 [S, k]: CACHE_CHECKS bits per lane
    global_bits: torch.Tensor  # int32 []: CACHE_GLOBAL_CHECKS bits
    bits: torch.Tensor         # int32 []: OR of everything

    def clean(self) -> bool:
        return int(self.bits) == 0


@dataclasses.dataclass
class ServeReport:
    """Violation bitmap over one ``ServeState`` (cache report included)."""

    cache: CacheReport
    slot_bits: torch.Tensor    # int32 [max_slots]: SLOT_CHECKS bits
    page_bits: torch.Tensor    # int32 [private_pages]: PAGE_CHECKS bits
    global_bits: torch.Tensor  # int32 []: SERVE_GLOBAL_CHECKS + SKETCH << 8
    bits: torch.Tensor         # int32 []: OR of everything

    def clean(self) -> bool:
        return int(self.bits) == 0


# ---------------------------------------------------------------------------
# cache invariants
# ---------------------------------------------------------------------------

def cache_lane_bits(cfg: KWayConfig, state: KWayState,
                    vals_mode: str = "any",
                    expiry_mode: str = "strict") -> torch.Tensor:
    """Per-lane violation bits, int32 [S, k]: tensor ops only, usable inside
    a replay loop (``recovery.validated_replay``) as in ``check_cache``.
    Expiry checks run only when the state carries an expiry lane;
    ``expiry_mode="lazy"`` skips ``expired_resident``."""
    if vals_mode not in ("any", "key", "slot"):
        raise ValueError(
            f"vals_mode must be 'any', 'key' or 'slot', got {vals_mode!r}")
    if expiry_mode not in ("strict", "lazy"):
        raise ValueError(
            f"expiry_mode must be 'strict' or 'lazy', got {expiry_mode!r}")
    keys, fpr = state.keys, state.fprint
    s, k = cfg.num_sets, cfg.ways
    dev = keys.device
    occupied = keys != EMPTY
    empty = ~occupied

    if cfg.layout == "soa":
        bits = _bit(occupied & (fpr != hashing.fingerprint(keys)), 0)
        empty_dirty = empty & ((fpr != 0) | (state.vals != 0)
                               | (state.meta_a != 0) | (state.meta_b != 0))
    else:  # aos: the fprint lane is unused by the probe; exclude it
        bits = torch.zeros((s, k), dtype=torch.int32, device=dev)
        empty_dirty = empty & ((state.vals != 0) | (state.meta_a != 0)
                               | (state.meta_b != 0))
    bits = bits | _bit(empty_dirty, 1)

    home = hashing.set_index(keys, s, cfg.seed)
    rows = torch.arange(s, device=dev)[:, None]
    bits = bits | _bit(occupied & (home != rows), 2)

    # duplicate key within a set: O(k^2) pairwise compare per row (k is
    # small by design: that is the paper)
    same = ((keys[:, :, None] == keys[:, None, :])
            & occupied[:, :, None] & occupied[:, None, :])
    bits = bits | _bit(same.sum(-1) > 1, 3)

    clk = state.clock
    a, b = state.meta_a, state.meta_b
    if cfg.policy in (Policy.LRU, Policy.FIFO):
        bad_meta = (a < 0) | (a >= clk) | (b != 0)
    elif cfg.policy == Policy.LFU:
        bad_meta = (a < 1) | (a > clk) | (b != 0)
    elif cfg.policy == Policy.RANDOM:
        bad_meta = (a != 0) | (b != 0)
    elif cfg.policy == Policy.HYPERBOLIC:
        bad_meta = (a < 1) | (a > clk) | (b < 0) | (b >= clk)
    else:  # pragma: no cover - Policy is a closed enum
        raise ValueError(f"unknown policy {cfg.policy}")
    bits = bits | _bit(occupied & bad_meta, 4)

    if vals_mode == "key":
        bits = bits | _bit(occupied & (state.vals != keys), 5)
    elif vals_mode == "slot":
        slot_id = rows * k + torch.arange(k, device=dev)[None]
        bits = bits | _bit(occupied & (state.vals != slot_id), 5)

    if state.expiry is not None:
        exp = state.expiry
        # an empty lane parks NO_EXPIRY: the same class of wear as a dirty
        # fprint / meta lane, folded into empty_lane_dirty
        bits = bits | _bit(empty & (exp != NO_EXPIRY), 1)
        if cfg.policy in (Policy.LRU, Policy.FIFO):
            # a last-touch (LRU) / insert (FIFO) stamp at or past the
            # deadline proves a hit was served on an expired entry
            bits = bits | _bit(occupied & (exp != NO_EXPIRY) & (a >= exp), 6)
        if expiry_mode == "strict":
            bits = bits | _bit(occupied & (exp <= clk), 7)
    return bits


def _cache_report(cfg: KWayConfig, state: KWayState, vals_mode: str,
                  expiry_mode: str = "strict") -> CacheReport:
    lane_bits = cache_lane_bits(cfg, state, vals_mode, expiry_mode)
    gbits = _bit(state.clock < 0, 0).reshape(())
    return CacheReport(lane_bits=lane_bits, global_bits=gbits,
                       bits=or_reduce(lane_bits) | gbits)


def check_cache(cfg: KWayConfig, state: KWayState, *,
                vals_mode: str = "any",
                expiry_mode: str = "strict") -> CacheReport:
    """Validate one cache state.  ``vals_mode``: ``"key"`` for the replay
    paths (val == key), ``"slot"`` for the serving engine (val == landing
    slot id), ``"any"`` to skip the payload check.  ``expiry_mode="lazy"``
    relaxes ``expired_resident`` for lazily scrubbed states."""
    return _cache_report(cfg, state, vals_mode, expiry_mode)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR in int64), int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def sketch_bits(cfg, st) -> torch.Tensor:
    """TinyLFU sketch violation bits (SKETCH_CHECKS), int32 [].  ``cfg`` is
    a ``TinyLFUConfig``, ``st`` a ``TinyLFUState``."""
    bad_add = (st.additions < 0) | (st.additions >= cfg.sample)
    pop = _popcount32(st.door).sum()
    return (_bit(bad_add, 0) | _bit(pop > st.additions, 1)).reshape(())


# ---------------------------------------------------------------------------
# hierarchy invariants
# ---------------------------------------------------------------------------

def unpack_tier(packed: torch.Tensor, ways: int, clock) -> KWayState:
    """One tier in the reference's packed row layout (int32 [S, 7*128]:
    keys | fprint | vals | meta_a | meta_b | scalar mailbox | expiry) -> a
    ``KWayState`` view with the expiry lane attached, what
    ``cache_lane_bits`` consumes.  The mailbox and way padding are
    dropped.  (The port's own tiers are plain ``KWayState``s.)"""
    packed = torch.as_tensor(packed).to(torch.int32)

    def sec(j):
        return packed[:, j * ROW_LANES: j * ROW_LANES + ways].contiguous()

    return KWayState(keys=sec(0), fprint=sec(1), vals=sec(2), meta_a=sec(3),
                     meta_b=sec(4),
                     clock=torch.as_tensor(clock, dtype=torch.int32).to(
                         packed.device),
                     expiry=sec(ROW_SECS - 1))


@dataclasses.dataclass
class HierReport:
    """Violation bitmap over one ``HierState`` (both tiers + exclusivity).
    ``double_bits`` carries the ``double_resident`` bit per L1 lane; the
    tier reports use ``expiry_mode="lazy"``."""

    l1: CacheReport
    l2: CacheReport
    double_bits: torch.Tensor  # int32 [S1, l1_ways]: bit 8 per L1 lane
    bits: torch.Tensor         # int32 []: OR of everything

    def clean(self) -> bool:
        return int(self.bits) == 0


def hier_lane_bits(cfg: KWayConfig, hier, state, vals_mode: str = "any"):
    """Per-lane violation bits of both tiers, shared by ``check_hier`` and
    ``recovery.scrub_hier`` -> (l1_bits [S1, l1_ways], l2_bits [S, k],
    double_bits [S1, l1_ways]); ``double_resident`` is reported on the L1
    lane holding the duplicated key."""
    from repro_torch.core.hierarchy import l1_config
    l1_bits = cache_lane_bits(l1_config(cfg, hier), state.l1, vals_mode,
                              "lazy")
    l2_bits = cache_lane_bits(cfg, state.l2, vals_mode, "lazy")
    keys1 = state.l1.keys
    occ = keys1 != EMPTY
    home = hashing.set_index(keys1, cfg.num_sets, cfg.seed)
    rows2 = state.l2.keys[home]             # [S1, l1_ways, ways]
    dup = occ & (rows2 == keys1[..., None]).any(-1)
    return l1_bits, l2_bits, _bit(dup, 8)


def check_hier(cfg: KWayConfig, hier, state, *,
               vals_mode: str = "any") -> HierReport:
    """Validate one ``HierState``: the per-lane catalogue on both tiers
    (the L1 routes with ``seed ^ L1_SEED_SALT``), plus L1/L2 exclusivity."""
    l1_bits, l2_bits, dbits = hier_lane_bits(cfg, hier, state, vals_mode)
    gb1 = _bit(state.l1.clock < 0, 0).reshape(())
    gb2 = _bit(state.l2.clock < 0, 0).reshape(())
    l1 = CacheReport(lane_bits=l1_bits, global_bits=gb1,
                     bits=or_reduce(l1_bits) | gb1)
    l2 = CacheReport(lane_bits=l2_bits, global_bits=gb2,
                     bits=or_reduce(l2_bits) | gb2)
    bits = l1.bits | l2.bits | or_reduce(dbits)
    return HierReport(l1=l1, l2=l2, double_bits=dbits, bits=bits)


def explain_hier(report: HierReport, limit: int = 32) -> list[str]:
    """Human-readable violations for a HierReport: both tier reports
    prefixed with their tier name, plus the double-resident lanes."""
    out = [f"l1 {s}" for s in explain_cache(report.l1, limit=limit)]
    out += [f"l2 {s}" for s in explain_cache(report.l2, limit=limit)]
    dbits = report.double_bits.cpu().numpy()
    for s, w in np.argwhere(dbits != 0)[:limit]:
        out.append(f"l1 set {int(s)} way {int(w)}: double_resident")
    return out


# ---------------------------------------------------------------------------
# serving-state invariants
# ---------------------------------------------------------------------------

def _nan_in_pool(pool: torch.Tensor, pages: int) -> torch.Tensor:
    """Any NaN in the real pages (the sink page past them excluded), one
    layer at a time so the check needs no pool-sized temporary."""
    found = torch.zeros((), dtype=torch.bool, device=pool.device)
    for layer in pool:
        found = found | torch.isnan(layer[:, :pages]).any()
    return found


def check_serve(ecfg, st) -> ServeReport:
    """Validate the port's ``ServeState`` against its ``EngineConfig``:
    the prefix cache (vals_mode="slot"), the TinyLFU sketch when enabled,
    page-table / owner referential integrity, per-slot counters and the KV
    pools' real pages."""
    from repro_torch.core import admission
    from repro_torch.serve.engine import COUNTERS

    kcfg = KWayConfig(num_sets=ecfg.num_sets, ways=ecfg.ways,
                      policy=ecfg.policy)
    n_slots = ecfg.max_batch
    n_priv = ecfg.private_pages
    shared = kcfg.capacity
    total = shared + n_priv
    page = ecfg.page
    pps = ecfg.max_seq // page
    dev = st.active.device
    i32 = torch.int32

    cache = _cache_report(kcfg, st.kstate, "slot")

    # ---- per slot --------------------------------------------------------
    active = st.active
    sbits = _bit(active & ((st.pos < 1) | (st.pos > ecfg.max_seq)), 0)
    sbits = sbits | _bit(active & ((st.n_pages < 0) | (st.n_pages > pps)
                                   | (st.pos > st.n_pages * page)), 1)
    valid_e = active[:, None] & (torch.arange(pps, device=dev)[None, :]
                                 < st.n_pages[:, None])
    in_range = (st.page_tbl >= 0) & (st.page_tbl < total)
    sbits = sbits | _bit((valid_e & ~in_range).any(1), 2)
    sbits = sbits | _bit(active & ((st.n_gen < 1)
                                   | (st.n_gen > st.max_new + 1)), 3)
    same_pg = ((st.page_tbl[:, :, None] == st.page_tbl[:, None, :])
               & valid_e[:, :, None] & valid_e[:, None, :])
    sbits = sbits | _bit((same_pg.sum(-1) > 1).any(1), 4)

    # ---- per private page ------------------------------------------------
    # refcount over the valid prefixes of active slots' page tables; shared
    # pages are legitimately multi-booked (the prefix cache), the private
    # region must be exclusive.  Entries out of it go to a sink count.
    is_priv = valid_e & (st.page_tbl >= shared) & in_range
    pidx = torch.where(is_priv, st.page_tbl - shared, n_priv).long()
    counts = torch.zeros(n_priv + 1, dtype=i32, device=dev).index_add_(
        0, pidx.reshape(-1), torch.ones(pidx.numel(), dtype=i32,
                                        device=dev))[:n_priv]
    slot_ids = torch.arange(n_slots, dtype=i32, device=dev)[:, None].expand(
        pidx.shape)
    ref_slot = torch.full((n_priv + 1,), -1, dtype=i32, device=dev)
    ref_slot = ref_slot.scatter_reduce(0, pidx.reshape(-1),
                                       slot_ids.reshape(-1),
                                       reduce="amax")[:n_priv]
    owner = st.owner
    pbits = _bit(counts > 1, 0)
    owned = owner >= 0
    pbits = pbits | _bit(((counts == 1) & (owner != ref_slot))
                         | (owned & (counts == 0)), 1)
    owner_c = owner.clamp(0, n_slots - 1).long()
    pbits = pbits | _bit(owned & ~active[owner_c], 2)
    pbits = pbits | _bit((owner < -1) | (owner >= n_slots), 3)

    # ---- global ----------------------------------------------------------
    gbits = _bit(_nan_in_pool(st.pool_k, total)
                 | _nan_in_pool(st.pool_v, total), 0)
    ctr = dict(zip(COUNTERS, st.counters))
    ctr_bad = ((ctr["prefix_hits"] < 0) | (ctr["prefix_lookups"] < 0)
               | (ctr["prefix_hits"] > ctr["prefix_lookups"])
               | (ctr["evictions"] < 0) | (ctr["prefills"] < 0)
               | (ctr["decode_steps"] < 0))
    gbits = gbits | _bit(ctr_bad, 1)
    if ecfg.tinylfu:
        sk_cfg = admission.for_capacity(kcfg.capacity)
        gbits = gbits | (sketch_bits(sk_cfg, st.sketch) << 8)

    bits = cache.bits | or_reduce(sbits) | or_reduce(pbits) | gbits
    return ServeReport(cache=cache, slot_bits=sbits, page_bits=pbits,
                       global_bits=gbits, bits=bits)


# ---------------------------------------------------------------------------
# host-side explain
# ---------------------------------------------------------------------------

def _named(bits: int, catalogue: dict, shift: int = 0) -> list[str]:
    return [name for i, name in catalogue.items()
            if bits & (1 << (i + shift))]


def explain_cache(report: CacheReport, limit: int = 32) -> list[str]:
    """A cache report as strings naming set / way and the violated
    invariants (pulls the bitmaps to the host once)."""
    lane_bits = report.lane_bits.cpu().numpy()
    out = [f"cache: {n}"
           for n in _named(int(report.global_bits), CACHE_GLOBAL_CHECKS)]
    for s, w in np.argwhere(lane_bits != 0)[:limit]:
        names = _named(int(lane_bits[s, w]), CACHE_CHECKS)
        out.append(f"set {int(s)} way {int(w)}: {'|'.join(names)}")
    n_bad = int((lane_bits != 0).sum())
    if n_bad > limit:
        out.append(f"... and {n_bad - limit} more corrupted lanes")
    return out


def explain_serve(report: ServeReport, limit: int = 32) -> list[str]:
    """Human-readable violations for a ServeReport: slot / page / global
    plus the embedded cache report."""
    out = explain_cache(report.cache, limit=limit)
    slot_bits = report.slot_bits.cpu().numpy()
    page_bits = report.page_bits.cpu().numpy()
    for (i,) in np.argwhere(slot_bits != 0)[:limit]:
        names = _named(int(slot_bits[i]), SLOT_CHECKS)
        out.append(f"slot {int(i)}: {'|'.join(names)}")
    for (p,) in np.argwhere(page_bits != 0)[:limit]:
        names = _named(int(page_bits[p]), PAGE_CHECKS)
        out.append(f"private page {int(p)}: {'|'.join(names)}")
    g = int(report.global_bits)
    out.extend(f"serve: {n}" for n in _named(g, SERVE_GLOBAL_CHECKS))
    out.extend(f"serve: {n}" for n in _named(g, SKETCH_CHECKS, shift=8))
    return out
