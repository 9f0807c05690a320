"""K-way set-associative cache as plain torch functions on tensors.

Counterpart of ``repro/core/kway.py`` with the same semantics, bit for bit:

    keys    int32 [S, k]   stored keys (uint32 bit patterns; EMPTY = -1)
    fprint  int32 [S, k]   16-bit fingerprints (SoA / KW-WFSC layout)
    vals    int32 [S, k]   payload
    meta_a  int32 [S, k]   policy lane A (LRU ts / LFU count / hyperbolic n)
    meta_b  int32 [S, k]   policy lane B (hyperbolic t0)
    clock   int32 []       logical clock
    expiry  int32 [S, k]   optional TTL deadline lane (``NO_EXPIRY`` = never)

A batch of B requests is one step; same-set collisions resolve as in the
reference: the first occurrence of a key inserts, the r-th distinct
inserting key of a set takes the r-th worst victim of its own order, at
most k admissions per set per batch.

Where JAX relies on dropped out-of-bounds scatters (inactive lanes parked
at set ``num_sets``), this module masks those lanes out before writing,
and the insert scatter keeps only the last writer of each ``(set, way)``
(``_last_writer``): torch ``index_put_`` with duplicate indices is
undefined on CUDA, while the reference's XLA scatter is last-write-wins.

Functions return new tensors; inputs are never written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import EMPTY
from repro_torch.core.policies import Policy, on_hit, on_insert, victim_scores

NEG_INF = -3.0e38

#: "never expires" deadline sentinel (int32 max).
NO_EXPIRY = 0x7FFFFFFF

_I32_LOW = -(2**31 - 1)

STATE_LANES = ("keys", "fprint", "vals", "meta_a", "meta_b")


@dataclasses.dataclass
class KWayState:
    """Cache contents: int32 tensors on one device."""

    keys: torch.Tensor
    fprint: torch.Tensor
    vals: torch.Tensor
    meta_a: torch.Tensor
    meta_b: torch.Tensor
    clock: torch.Tensor                    # int32 []
    expiry: Optional[torch.Tensor] = None  # int32 [S, k] | None

    @property
    def num_sets(self) -> int:
        return self.keys.shape[0]

    @property
    def ways(self) -> int:
        return self.keys.shape[1]

    @property
    def capacity(self) -> int:
        return self.keys.numel()

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def occupancy(self) -> torch.Tensor:
        return (self.keys != EMPTY).sum()

    def nbytes(self) -> int:
        lanes = [getattr(self, f) for f in STATE_LANES] + [self.expiry]
        return sum(t.numel() * t.element_size() for t in lanes
                   if t is not None)


@dataclasses.dataclass(frozen=True)
class KWayConfig:
    """Static cache configuration."""

    num_sets: int
    ways: int
    policy: Policy = Policy.LRU
    layout: str = "soa"          # "soa" (KW-WFSC) | "aos" (KW-WFA)
    sample: int = 0              # >0: sampled policy over `sample` ways
    seed: int = 0x51CA

    def __post_init__(self):
        if self.num_sets < 1 or self.num_sets & (self.num_sets - 1):
            raise ValueError("num_sets must be a power of two")
        if self.ways < 1:
            raise ValueError("ways must be >= 1")
        if self.layout not in ("soa", "aos"):
            raise ValueError(f"unknown layout {self.layout!r}")

    @property
    def capacity(self) -> int:
        return self.num_sets * self.ways


def fully_associative(capacity: int, policy: Policy,
                      sample: int = 0) -> KWayConfig:
    """The paper's baseline: one set spanning the whole cache."""
    return KWayConfig(num_sets=1, ways=capacity, policy=policy, sample=sample)


def make_cache(cfg: KWayConfig, *, device, ttl: bool = False) -> KWayState:
    shape = (cfg.num_sets, cfg.ways)

    def full(v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return KWayState(
        keys=full(EMPTY), fprint=full(0), vals=full(0), meta_a=full(0),
        meta_b=full(0),
        clock=torch.zeros((), dtype=torch.int32, device=device),
        expiry=full(NO_EXPIRY) if ttl else None,
    )


def ensure_expiry(state: KWayState) -> KWayState:
    """Attach an all-``NO_EXPIRY`` expiry lane if the state lacks one."""
    if state.expiry is not None:
        return state
    return dataclasses.replace(
        state, expiry=torch.full_like(state.keys, NO_EXPIRY))


def state_from_numpy(arrays: dict, *, device) -> KWayState:
    """A reference ``KWayState``'s leaves as numpy arrays (uint32
    keys/fprint, int32 vals/meta_a/meta_b/clock[/expiry]) -> port state.
    Any leading axes carry over: a sharded state's ``[D, S/D, k]`` lanes
    and ``[D]`` clock too."""
    def lane(name):
        a = np.array(arrays[name])            # a writable copy
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)

    exp = arrays.get("expiry")
    return KWayState(
        keys=lane("keys"), fprint=lane("fprint"), vals=lane("vals"),
        meta_a=lane("meta_a"), meta_b=lane("meta_b"),
        clock=torch.from_numpy(np.array(arrays["clock"], np.int32)).to(
            device),
        expiry=None if exp is None else lane("expiry"),
    )


def state_to_numpy(state: KWayState) -> dict:
    """Port state -> the reference's leaves as numpy arrays."""
    def lane(t):
        return t.detach().cpu().numpy()

    out = {
        "keys": lane(state.keys).view(np.uint32),
        "fprint": lane(state.fprint).view(np.uint32),
        "vals": lane(state.vals), "meta_a": lane(state.meta_a),
        "meta_b": lane(state.meta_b), "clock": lane(state.clock),
    }
    if state.expiry is not None:
        out["expiry"] = lane(state.expiry)
    return out


def scrub_expired(state: KWayState, horizon: torch.Tensor) -> KWayState:
    """Reclaim every entry whose deadline is at or before ``horizon`` (the
    batch-exit clock).  No-op without an expiry lane."""
    if state.expiry is None:
        return state
    dead = (state.keys != EMPTY) & (state.expiry <= horizon)

    def clear(t, v):
        return torch.where(dead, torch.full_like(t, v), t)

    return dataclasses.replace(
        state, keys=clear(state.keys, EMPTY), fprint=clear(state.fprint, 0),
        vals=clear(state.vals, 0), meta_a=clear(state.meta_a, 0),
        meta_b=clear(state.meta_b, 0), expiry=clear(state.expiry, NO_EXPIRY))


def insert_deadlines(clock: torch.Tensor, b: int,
                     ttls: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``clock + 2B + ttl`` per lane (int32 wrap), ``NO_EXPIRY`` for
    ``ttl <= 0``."""
    if ttls is None:
        return None
    ttls = ttls.to(torch.int32)
    dl = clock + (2 * b) + ttls
    return torch.where(ttls > 0, dl, torch.full_like(dl, NO_EXPIRY))


# ---------------------------------------------------------------------------
# probing
# ---------------------------------------------------------------------------

def route(cfg: KWayConfig, qkeys: torch.Tensor):
    """Sanitize int32 key lanes and map them to sets -> (qkeys, sets int64)."""
    qkeys = hashing.sanitize_keys(qkeys)
    return qkeys, hashing.set_index(qkeys, cfg.num_sets, cfg.seed)


def _probe(cfg: KWayConfig, state: KWayState, qkeys: torch.Tensor):
    """-> (qkeys, sets, set_keys [B,k], hit [B], way [B]); ``way`` is the
    first matching way, 0 on a miss."""
    qkeys, sets = route(cfg, qkeys)
    set_keys = state.keys[sets]
    eq = set_keys == qkeys[:, None]
    if cfg.layout == "soa":
        eq = eq & (state.fprint[sets] == hashing.fingerprint(qkeys)[:, None])
    eq = eq & (set_keys != EMPTY)
    hit = eq.any(dim=-1)
    way = eq.to(torch.int8).argmax(dim=-1)
    return qkeys, sets, set_keys, hit, way


def _batch_times(state: KWayState, b: int):
    times = state.clock + torch.arange(b, dtype=torch.int32,
                                       device=state.device)
    return times, state.clock + b


def _new_groups(sorted_vals: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_vals, dtype=torch.bool)
    first[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return first


def _intra_batch_rank(sets: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """rank[i] = #(j<i : active[j] and sets[j]==sets[i]) for active i."""
    b = sets.shape[0]
    order_key = torch.where(active, sets.to(torch.int64),
                            torch.full_like(sets, 0x7FFFFFFF, dtype=torch.int64))
    sorted_keys, perm = torch.sort(order_key, stable=True)
    idx = torch.arange(b, dtype=torch.int64, device=sets.device)
    start = torch.where(_new_groups(sorted_keys), idx, torch.zeros_like(idx))
    group_start = torch.cummax(start, dim=0).values
    rank = torch.empty_like(idx).scatter_(0, perm, idx - group_start)
    return torch.where(active, rank, torch.zeros_like(rank))


def _first_occurrence(qkeys: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """True for the first active occurrence of each key in the batch.
    Inactive lanes sort under EMPTY, which is never a sanitized key."""
    order_key = torch.where(active, qkeys, torch.full_like(qkeys, EMPTY))
    sorted_keys, perm = torch.sort(order_key, stable=True)
    first = torch.empty_like(active).scatter_(0, perm, _new_groups(sorted_keys))
    return first & active


def _last_writer(flat: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Active lanes that no later active lane overwrites at the same flat
    slot: the last-write-wins outcome of the reference's insert scatter."""
    key = torch.where(active, flat, torch.full_like(flat, -1))
    sorted_keys, perm = torch.sort(key, stable=True)
    last = torch.ones_like(active)
    last[:-1] = sorted_keys[:-1] != sorted_keys[1:]
    keep = torch.empty_like(active).scatter_(0, perm, last)
    return keep & active


def sampled_way_ids(sample: int, ways: int, times: torch.Tensor) -> torch.Tensor:
    """Pseudo-random way ids (with replacement) for sampled victim selection:
    ``times`` int32 [...] -> int64 [..., sample]."""
    draw = torch.arange(sample, dtype=torch.int64, device=times.device)
    t = hashing._mul32(hashing.as_u32(times)[..., None], 2654435761)
    h = hashing.hash_u32((draw + t) & 0xFFFFFFFF, seed=0x5A5A)
    return h % ways


def _victim_order_arrays(cfg: KWayConfig, keys_arr, meta_a_arr, meta_b_arr,
                         sets, set_keys, times):
    """Per request: the ways of its set worst-victim-first, [B, k] (or
    [B, sample] for sampled policies), int64."""
    if 0 < cfg.sample < cfg.ways:
        way_ids = sampled_way_ids(cfg.sample, cfg.ways, times)     # [B, m]
        rows = sets[:, None]
        ma = meta_a_arr[rows, way_ids]
        mb = meta_b_arr[rows, way_ids]
        keys_s = keys_arr[rows, way_ids]
        scores = victim_scores(cfg.policy, ma, mb, times[:, None], keys_s)
        scores = torch.where(keys_s == EMPTY, torch.full_like(scores, NEG_INF),
                             scores)
        order_local = torch.argsort(scores, dim=-1, stable=True)
        return torch.gather(way_ids, 1, order_local)
    scores = victim_scores(cfg.policy, meta_a_arr[sets], meta_b_arr[sets],
                           times[:, None], set_keys)
    scores = torch.where(set_keys == EMPTY, torch.full_like(scores, NEG_INF),
                         scores)
    return torch.argsort(scores, dim=-1, stable=True)


def _victim_order(cfg, state, sets, set_keys, times):
    return _victim_order_arrays(cfg, state.keys, state.meta_a, state.meta_b,
                                sets, set_keys, times)


def _resolve_inserts(cfg: KWayConfig, qkeys, sets, eligible, order):
    """Dedupe, same-set rank, cap at k admits per set, rank-th victim ->
    (is_insert bool[B], way_victim int64[B])."""
    is_insert = eligible & _first_occurrence(qkeys, eligible)
    rank = _intra_batch_rank(sets, is_insert)
    is_insert = is_insert & (rank < cfg.ways)
    rank_c = rank.clamp(0, order.shape[1] - 1)
    way_victim = torch.gather(order.to(torch.int64), 1, rank_c[:, None])[:, 0]
    return is_insert, way_victim


def _write(lane: torch.Tensor, flat: torch.Tensor, keep: torch.Tensor,
           values) -> torch.Tensor:
    """Copy of ``lane`` with ``values`` written at the flat slots of the
    ``keep`` lanes (indices are unique among them).  The other lanes write
    to one scratch slot past the end, which is dropped: no boolean indexing,
    so no device-to-host sync."""
    n = lane.numel()
    out = torch.empty(n + 1, dtype=lane.dtype, device=lane.device)
    out[:n] = lane.reshape(-1)
    values = torch.as_tensor(values, dtype=lane.dtype, device=lane.device)
    out.index_put_((torch.where(keep, flat, n),), values.expand(flat.shape))
    return out[:n].view(lane.shape)


def _hit_meta_a(cfg: KWayConfig, meta_a, sets, way, hit, times):
    """Hit-phase ``meta_a``: scatter-add (LFU/HYPERBOLIC) or scatter-max
    (LRU) over duplicate (set, way) pairs; identity for FIFO/RANDOM."""
    if cfg.policy in (Policy.FIFO, Policy.RANDOM):
        return meta_a
    flat = sets * cfg.ways + way
    out = meta_a.clone()
    if cfg.policy in (Policy.LFU, Policy.HYPERBOLIC):
        out.view(-1).index_put_((flat,), hit.to(torch.int32), accumulate=True)
    else:
        src = torch.where(hit, times, torch.full_like(times, _I32_LOW))
        out.view(-1).scatter_reduce_(0, flat, src, reduce="amax")
    return out


# ---------------------------------------------------------------------------
# decision application (shared by every probe implementation)
# ---------------------------------------------------------------------------

def apply_get(cfg: KWayConfig, state: KWayState, sets, hit, way):
    """Apply read-side metadata updates -> (state', hit[B], vals[B])."""
    times, clock = _batch_times(state, sets.shape[0])
    meta_a = _hit_meta_a(cfg, state.meta_a, sets, way, hit, times)
    vals = torch.where(hit, state.vals[sets, way],
                       torch.full_like(times, -1))
    return dataclasses.replace(state, meta_a=meta_a, clock=clock), hit, vals


def apply_put(cfg: KWayConfig, state: KWayState, qkeys, qvals, sets, present,
              way_present, order, admit=None, enabled=None, *,
              slot_value: bool = False):
    """Apply write decisions -> (state', evicted_keys[B], evicted_valid[B],
    slot_sets[B], slot_ways[B]); slot_* are -1 where the key did not land.
    ``evicted_keys`` are int32 bit patterns."""
    b = qkeys.shape[0]
    dev = state.device
    times, clock = _batch_times(state, b)
    ones = torch.ones((b,), dtype=torch.bool, device=dev)
    admit = ones if admit is None else admit.to(dev)
    enabled = ones if enabled is None else enabled.to(dev)
    present = present & enabled

    is_insert, way_victim = _resolve_inserts(
        cfg, qkeys, sets, (~present) & admit & enabled, order)
    way = torch.where(present, way_present, way_victim)
    active = present | is_insert

    evicted_keys = state.keys[sets, way_victim]
    evicted_valid = is_insert & (evicted_keys != EMPTY)

    ia, ib = on_insert(cfg.policy, times, (b,))
    ha, hb = on_hit(cfg.policy, state.meta_a[sets, way],
                    state.meta_b[sets, way], times)
    new_a = torch.where(present, ha, ia)
    new_b = torch.where(present, hb, ib)
    if slot_value:
        qvals = (sets * cfg.ways + way).to(torch.int32)

    flat = sets * cfg.ways + way
    keep = _last_writer(flat, active)
    new_state = KWayState(
        keys=_write(state.keys, flat, keep, qkeys),
        fprint=_write(state.fprint, flat, keep, hashing.fingerprint(qkeys)),
        vals=_write(state.vals, flat, keep, qvals),
        meta_a=_write(state.meta_a, flat, keep, new_a),
        meta_b=_write(state.meta_b, flat, keep, new_b),
        clock=clock,
        expiry=(None if state.expiry is None
                else _write(state.expiry, flat, keep, NO_EXPIRY)),
    )
    neg = torch.full_like(flat, -1)
    return (new_state, evicted_keys, evicted_valid,
            torch.where(active, sets, neg), torch.where(active, way, neg))


def apply_access(cfg: KWayConfig, state: KWayState, qkeys, qvals, sets,
                 hit_raw, way, admit=None, enabled=None, order=None,
                 set_keys=None, ttls=None, *, slot_value: bool = False):
    """Fused get-then-put-on-miss apply for one probe's decisions.

    Hits stamp ``t+i``, inserts ``t+B+i``, and the clock advances by 2B.
    ``order`` (worst-victim-first, scored on the post-hit metadata at the
    put times) may come from the fused probe kernel; otherwise it is
    computed here from ``set_keys``.  ``hit_raw`` is unmasked by
    ``enabled``.  Returns (state', hit[B], vals[B], evicted_keys[B],
    evicted_valid[B])."""
    if ttls is not None and state.expiry is None:
        raise ValueError(
            "apply_access: ttls given but the state has no expiry lane — "
            "build it with make_cache(cfg, ttl=True) or ensure_expiry()")
    b = qkeys.shape[0]
    dev = state.device
    times_get = state.clock + torch.arange(b, dtype=torch.int32, device=dev)
    times_put = times_get + b
    clock = state.clock + 2 * b
    hit = hit_raw if enabled is None else hit_raw & enabled.to(dev)

    meta_a1 = _hit_meta_a(cfg, state.meta_a, sets, way, hit, times_get)
    vals_out = torch.where(hit, state.vals[sets, way], qvals)

    ones = torch.ones((b,), dtype=torch.bool, device=dev)
    admit = ones if admit is None else admit.to(dev)
    enabled = ones if enabled is None else enabled.to(dev)
    if order is None:
        order = _victim_order_arrays(cfg, state.keys, meta_a1, state.meta_b,
                                     sets, set_keys, times_put)
    is_insert, way_victim = _resolve_inserts(
        cfg, qkeys, sets, (~hit_raw) & admit & enabled, order)

    evicted_keys = state.keys[sets, way_victim]
    evicted_valid = is_insert & (evicted_keys != EMPTY)

    if slot_value:
        slot_id = (sets * cfg.ways + way_victim).to(torch.int32)
        qvals = slot_id
        vals_out = torch.where(
            hit, state.vals[sets, way],
            torch.where(is_insert, slot_id, torch.full_like(slot_id, -1)))

    ia, ib = on_insert(cfg.policy, times_put, (b,))
    flat = sets * cfg.ways + way_victim
    keep = _last_writer(flat, is_insert)
    expiry = state.expiry
    if expiry is not None:
        ie = insert_deadlines(state.clock, b, ttls)
        expiry = _write(expiry, flat, keep,
                        NO_EXPIRY if ie is None else ie)
    new_state = KWayState(
        keys=_write(state.keys, flat, keep, qkeys),
        fprint=_write(state.fprint, flat, keep, hashing.fingerprint(qkeys)),
        vals=_write(state.vals, flat, keep, qvals),
        meta_a=_write(meta_a1, flat, keep, ia),
        meta_b=_write(state.meta_b, flat, keep, ib),
        clock=clock, expiry=expiry)
    return new_state, hit, vals_out, evicted_keys, evicted_valid


# ---------------------------------------------------------------------------
# public operations (``qkeys`` / ``qvals`` int32 tensors on the state's device)
# ---------------------------------------------------------------------------

def get(cfg: KWayConfig, state: KWayState, qkeys, enabled=None):
    """Batched read -> (state', hit bool[B], vals int32[B])."""
    _, sets, _, hit, way = _probe(cfg, state, qkeys)
    if enabled is not None:
        hit = hit & enabled.to(state.device)
    return apply_get(cfg, state, sets, hit, way)


def put(cfg: KWayConfig, state: KWayState, qkeys, qvals, admit=None,
        enabled=None, *, slot_value: bool = False):
    """Batched write -> (state', evicted_keys, evicted_valid, slot_sets,
    slot_ways)."""
    qkeys, sets, set_keys, present, way_present = _probe(cfg, state, qkeys)
    times, _ = _batch_times(state, qkeys.shape[0])
    order = _victim_order(cfg, state, sets, set_keys, times)
    return apply_put(cfg, state, qkeys, qvals, sets, present, way_present,
                     order, admit, enabled, slot_value=slot_value)


def access(cfg: KWayConfig, state: KWayState, qkeys, qvals,
           admit_on_miss=None, enabled=None, ttls=None, *,
           slot_value: bool = False):
    """The canonical cache loop (get; on miss, put), fused single-probe
    form -> (state', hit, vals, evicted_keys, evicted_valid).  Expired
    entries are scrubbed before the probe."""
    if state.expiry is not None:
        state = scrub_expired(state, state.clock + 2 * qkeys.shape[0])
    qkeys, sets, set_keys, hit_raw, way = _probe(cfg, state, qkeys)
    return apply_access(cfg, state, qkeys, qvals, sets, hit_raw, way,
                        admit_on_miss, enabled, set_keys=set_keys, ttls=ttls,
                        slot_value=slot_value)


def access_two_phase(cfg: KWayConfig, state: KWayState, qkeys, qvals,
                     admit_on_miss=None, enabled=None, *,
                     slot_value: bool = False):
    """The unfused get-then-put composition: the oracle for ``access``."""
    state, hit, vals = get(cfg, state, qkeys, enabled=enabled)
    en = (~hit) if enabled is None else (enabled.to(state.device) & ~hit)
    state, ek, ev, ss, sw = put(cfg, state, qkeys, qvals,
                                admit=admit_on_miss, enabled=en,
                                slot_value=slot_value)
    if slot_value:
        slot_id = (ss * cfg.ways + sw).to(torch.int32)
        vals = torch.where(hit, vals, torch.where(
            ss >= 0, slot_id, torch.full_like(slot_id, -1)))
    else:
        vals = torch.where(hit, vals, qvals)
    return state, hit, vals, ek, ev


def peek_victims(cfg: KWayConfig, state: KWayState, qkeys):
    """Prospective victim key per query, no mutation -> (victim_keys int32
    bit patterns [B], victim_valid bool [B])."""
    _, sets, set_keys, present, _ = _probe(cfg, state, qkeys)
    times, _ = _batch_times(state, qkeys.shape[0])
    way0 = _victim_order(cfg, state, sets, set_keys, times)[:, 0]
    vkeys = state.keys[sets, way0]
    return vkeys, (vkeys != EMPTY) & (~present)



def replay_chunks(access, state: KWayState, qkeys, enabled, ttls=None):
    """The chunked replay loop, one ``access(state, keys, vals, admit,
    enabled[, ttls=])`` call per chunk (payload ``val == key``): the plain
    version of the replay kernel.  ``qkeys`` int32 [T, B], ``enabled`` bool
    [T, B], optional ``ttls`` int32 [T, B], all on the state's device.
    -> (hits int32 [T], evs int32 [T], state')."""
    if ttls is not None:
        state = ensure_expiry(state)
    hits = torch.zeros(qkeys.shape[0], dtype=torch.int32, device=state.device)
    evs = torch.zeros_like(hits)
    for t in range(qkeys.shape[0]):
        kw = {} if ttls is None else {"ttls": ttls[t]}
        state, hit, _, _, ev = access(state, qkeys[t], qkeys[t], None,
                                      enabled[t], **kw)
        hits[t] = hit.sum()
        evs[t] = ev.sum()
    return hits, evs, state


# ---------------------------------------------------------------------------
# AoS record packing (the KW-WFA layout baseline)
# ---------------------------------------------------------------------------

def pack_aos(state: KWayState) -> torch.Tensor:
    """Interleave the SoA lanes into one int32 [S, k, 4] record array
    (keys, vals, meta_a, meta_b): KW-WFA keeps a node per way, so reading
    a record touches 4 interleaved words."""
    return torch.stack([state.keys, state.vals, state.meta_a, state.meta_b],
                       dim=-1)


def unpack_aos(rec: torch.Tensor, clock: torch.Tensor) -> KWayState:
    """The inverse of ``pack_aos``; ``fprint`` is recomputed from the keys
    (as the reference does, empty ways included)."""
    keys = rec[..., 0]
    return KWayState(keys=keys, fprint=hashing.fingerprint(keys),
                     vals=rec[..., 1], meta_a=rec[..., 2],
                     meta_b=rec[..., 3], clock=clock)
