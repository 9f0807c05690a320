"""Deterministic fault injector: every fault reproducible from
``(seed, site, step)``.

Counterpart of ``repro/robust/faults.py``.  Every injector draws from
``numpy.random.default_rng([seed, step, crc32(site)])``, the reference's
contract, so the same call on the same state injects the same fault as the
reference: the same lane, bit and value.  The draws are made on the host
from what they need (the occupied lanes, the booked pages); the tensors
are changed on their own device, in a copy: every injector returns
``(mutated, FaultReport)`` and leaves its input as it was.

Fault classes: ``flip_bit`` (a single-event upset in an occupied lane,
metadata flips confined to bits 24-31 so they are detectable),
``clock_skew`` (the clock jumps onto a live deadline), ``stale_entry`` (a
deadline rewritten to the lane's own last touch), ``double_resident`` (an
L1 entry copied into its L2 home set), ``inject_nan`` (a NaN in a KV
pool), ``double_book_page`` (a page-table entry redirected onto a booked
private page), ``stale_owner`` (a private page's owner orphaned or
redirected), ``crashed_save`` (a checkpoint written and never committed)
and ``corrupt_trace`` (duplicated submits and poison keys, which the stack
must survive, not detect).  ``FaultReport.before`` / ``after`` of a
``keys`` or ``fprint`` flip hold the uint32 values, as the reference's.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import EMPTY_KEY
from repro_torch.core.kway import NO_EXPIRY, KWayState

__all__ = ["FaultReport", "rng_for", "flip_bit", "inject_nan",
           "double_book_page", "stale_owner", "crashed_save",
           "corrupt_trace", "clock_skew", "stale_entry", "double_resident"]

#: cache-lane sites accepted by flip_bit
LANE_SITES = ("keys", "fprint", "vals", "meta_a", "meta_b")
#: lanes the reference keeps as uint32
_U32_SITES = ("keys", "fprint")


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """What was injected, precisely enough to assert detection against."""

    kind: str          # "bit_flip" | "nan" | "double_book" | ...
    site: str          # lane/tensor name or stream kind
    index: tuple       # coordinates of the mutated element(s)
    bit: int           # flipped bit position (-1 when not a bit flip)
    before: float      # prior value (as float for uniformity)
    after: float       # mutated value
    seed: int
    step: int


def rng_for(seed: int, site: str, step: int = 0) -> np.random.Generator:
    """The (seed, site, step) -> RNG contract all injectors share."""
    return np.random.default_rng([seed, step, zlib.crc32(site.encode())])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _patched(t: torch.Tensor, index, value) -> torch.Tensor:
    out = t.clone()
    out[index] = value
    return out


def flip_bit(state: KWayState, site: str, seed: int,
             step: int = 0) -> tuple[KWayState, FaultReport]:
    """Flip one bit in an *occupied* lane of ``site``.  Raises
    ``ValueError`` on an empty cache or an unknown site."""
    if site not in LANE_SITES:
        raise ValueError(f"flip_bit site must be one of {LANE_SITES}, "
                         f"got {site!r}")
    rng = rng_for(seed, site, step)
    occ = np.argwhere(_u32(state.keys) != np.uint32(EMPTY_KEY))
    if occ.size == 0:
        raise ValueError("flip_bit: cache has no occupied lanes")
    s, w = (int(v) for v in occ[rng.integers(len(occ))])
    if site in ("meta_a", "meta_b"):
        bit = int(rng.integers(24, 32))   # out-of-bounds-detectable range
    else:
        bit = int(rng.integers(0, 32))
    lane = getattr(state, site)
    before = int(lane[s, w])
    after = hashing.to_i32(torch.tensor((before & 0xFFFFFFFF) ^ (1 << bit)))
    new = _patched(lane, (s, w), after.to(lane.device))
    after = int(after)
    if site in _U32_SITES:
        before, after = before & 0xFFFFFFFF, after & 0xFFFFFFFF
    report = FaultReport(kind="bit_flip", site=site, index=(s, w), bit=bit,
                         before=float(before), after=float(after),
                         seed=seed, step=step)
    return dataclasses.replace(state, **{site: new}), report


def clock_skew(state: KWayState, seed: int,
               step: int = 0) -> tuple[KWayState, FaultReport]:
    """Jump the clock onto a live deadline, turning the entry holding it
    (and every earlier deadline) expired-but-resident: the
    ``expired_resident`` bit must fire.  Needs a TTL state with an occupied
    lane whose deadline is ahead of the clock; raises ``ValueError``
    otherwise."""
    if state.expiry is None:
        raise ValueError("clock_skew needs a TTL state (expiry lane)")
    rng = rng_for(seed, "clock", step)
    keys = _u32(state.keys)
    exp = state.expiry.cpu().numpy()
    clock = int(state.clock)
    live = np.argwhere((keys != np.uint32(EMPTY_KEY))
                       & (exp != NO_EXPIRY) & (exp > clock))
    if live.size == 0:
        raise ValueError("clock_skew: no occupied lane with a live deadline")
    s, w = (int(v) for v in live[rng.integers(len(live))])
    after = int(exp[s, w])    # clock == deadline => exp <= clock => expired
    report = FaultReport(kind="clock_skew", site="clock", index=(s, w),
                         bit=-1, before=float(clock), after=float(after),
                         seed=seed, step=step)
    return dataclasses.replace(state, clock=torch.full_like(
        state.clock, after)), report


def stale_entry(state: KWayState, seed: int,
                step: int = 0) -> tuple[KWayState, FaultReport]:
    """Rewrite one occupied lane's deadline to its own last-touch stamp:
    the forged signature of a hit served on an expired entry, which the
    ``expired_hit`` bit detects (``meta_a >= exp``).  Needs a TTL state;
    raises ``ValueError`` on an empty cache."""
    if state.expiry is None:
        raise ValueError("stale_entry needs a TTL state (expiry lane)")
    rng = rng_for(seed, "expiry", step)
    occ = np.argwhere(_u32(state.keys) != np.uint32(EMPTY_KEY))
    if occ.size == 0:
        raise ValueError("stale_entry: cache has no occupied lanes")
    s, w = (int(v) for v in occ[rng.integers(len(occ))])
    before = int(state.expiry[s, w])
    after = int(state.meta_a[s, w])
    report = FaultReport(kind="stale_entry", site="expiry", index=(s, w),
                         bit=-1, before=float(before), after=float(after),
                         seed=seed, step=step)
    return dataclasses.replace(
        state, expiry=_patched(state.expiry, (s, w), after)), report


def double_resident(cfg, state, seed: int, step: int = 0):
    """Copy one L1-resident entry into a way of its L2 home set: the
    lost-update interleaving that breaks tier exclusivity, detected by
    ``check_hier``'s ``double_resident`` bit.  ``cfg`` is the L2
    ``KWayConfig``, ``state`` a ``HierState``; raises ``ValueError`` when
    no L1 entry is absent from its L2 home row."""
    rng = rng_for(seed, "l2.keys", step)
    l1, l2 = state.l1, state.l2
    k1 = _u32(l1.keys)
    k2 = _u32(l2.keys)
    home = hashing.set_index(l1.keys, cfg.num_sets, cfg.seed).cpu().numpy()
    occ = np.argwhere(k1 != np.uint32(EMPTY_KEY))
    cands = [(int(s), int(w)) for s, w in occ
             if int(k1[s, w]) not in k2[home[s, w]].tolist()]
    if not cands:
        raise ValueError(
            "double_resident: every L1 entry already shares its L2 home "
            "row (or L1 is empty)")
    s1, w1 = cands[rng.integers(len(cands))]
    s2 = int(home[s1, w1])
    row = k2[s2]
    empties = np.flatnonzero(row == np.uint32(EMPTY_KEY))
    w2 = int(empties[0]) if empties.size else int(rng.integers(cfg.ways))
    before = int(row[w2])

    def patch(t, src):
        return _patched(t, (s2, w2), src)

    l2 = dataclasses.replace(
        l2,
        keys=patch(l2.keys, l1.keys[s1, w1]),
        fprint=patch(l2.fprint, l1.fprint[s1, w1]),
        vals=patch(l2.vals, l1.vals[s1, w1]),
        meta_a=patch(l2.meta_a, l1.meta_a[s1, w1]),
        meta_b=patch(l2.meta_b, l1.meta_b[s1, w1]),
        expiry=(None if l2.expiry is None else
                patch(l2.expiry, l1.expiry[s1, w1]
                      if l1.expiry is not None else NO_EXPIRY)))
    report = FaultReport(kind="double_resident", site="l2.keys",
                         index=(s2, w2), bit=-1, before=float(before),
                         after=float(int(k1[s1, w1])), seed=seed, step=step)
    return dataclasses.replace(state, l2=l2), report


def inject_nan(pool: torch.Tensor, seed: int, step: int = 0,
               site: str = "pool_k", *,
               pages: int | None = None) -> tuple[torch.Tensor, FaultReport]:
    """Set one element of a (floating) KV pool tensor to NaN.  ``pages``
    limits the draw to the first ``pages`` pages of the page axis (axis 2):
    the port's ``ServeState`` pools carry a sink page past the real ones,
    and with ``pages`` the draw is the reference's on the pool without
    it."""
    rng = rng_for(seed, site, step)
    shape = tuple(pool.shape)
    if pages is not None:
        shape = shape[:2] + (pages,) + shape[3:]
    flat = int(rng.integers(int(np.prod(shape))))
    idx = tuple(int(i) for i in np.unravel_index(flat, shape))
    before = float(pool[idx])
    report = FaultReport(kind="nan", site=site, index=idx, bit=-1,
                         before=before, after=float("nan"),
                         seed=seed, step=step)
    return _patched(pool, idx, float("nan")), report


def _active_private_entries(ecfg, st) -> np.ndarray:
    """[n, 3] rows (slot, entry_index, page_id) of valid private-page
    page-table entries of active slots."""
    shared = ecfg.num_sets * ecfg.ways
    tbl = st.page_tbl.cpu().numpy()
    n_pages = st.n_pages.cpu().numpy()
    active = st.active.cpu().numpy()
    rows = []
    for slot in np.flatnonzero(active):
        for j in range(int(n_pages[slot])):
            pg = int(tbl[slot, j])
            if pg >= shared:
                rows.append((int(slot), j, pg))
    return np.asarray(rows, np.int64).reshape(-1, 3)


def double_book_page(ecfg, st, seed: int, step: int = 0):
    """Redirect one valid page-table entry onto a *different* private page
    that is already booked.  Raises ``ValueError`` when fewer than two
    private bookings exist to collide."""
    rng = rng_for(seed, "page_tbl", step)
    entries = _active_private_entries(ecfg, st)
    if len(entries) < 2:
        raise ValueError("double_book_page: need >= 2 booked private pages")
    i, j = rng.choice(len(entries), size=2, replace=False)
    victim_slot, victim_entry, before_pg = (int(v) for v in entries[i])
    target_pg = int(entries[j][2])
    report = FaultReport(kind="double_book", site="page_tbl",
                         index=(victim_slot, victim_entry), bit=-1,
                         before=float(before_pg), after=float(target_pg),
                         seed=seed, step=step)
    return dataclasses.replace(st, page_tbl=_patched(
        st.page_tbl, (victim_slot, victim_entry), target_pg)), report


def stale_owner(ecfg, st, seed: int, step: int = 0):
    """Corrupt the owner lane of one booked private page: orphan it
    (``owner = -1``) or point it at another slot.  Raises ``ValueError``
    when no private page is booked."""
    rng = rng_for(seed, "owner", step)
    owner = st.owner.cpu().numpy()
    booked = np.flatnonzero(owner >= 0)
    if booked.size == 0:
        raise ValueError("stale_owner: no booked private pages")
    p = int(booked[rng.integers(booked.size)])
    before = int(owner[p])
    wrong = int(rng.integers(-1, ecfg.max_batch))
    if wrong == before:   # ensure the fault is a fault
        wrong = -1 if before != -1 else (before + 1) % ecfg.max_batch
    report = FaultReport(kind="stale_owner", site="owner", index=(p,),
                         bit=-1, before=float(before), after=float(wrong),
                         seed=seed, step=step)
    return dataclasses.replace(st, owner=_patched(st.owner, p, wrong)), report


def crashed_save(tree, root, step: int) -> str:
    """A crash between the checkpoint write and its commit: every leaf
    lands under ``step_N.tmp`` but the atomic rename never happens, so
    ``latest_step`` / ``restore`` must ignore it.  Returns the orphaned
    tmp path."""
    from repro_torch.ckpt import manager
    return manager.save(root, step, tree, commit=False)


def corrupt_trace(trace, kind: str, seed: int, step: int = 0,
                  n: int = 4) -> tuple[np.ndarray, FaultReport]:
    """Request-stream faults the stack must survive.  ``kind="dup"``:
    ``n`` entries overwritten with their predecessor (duplicate submits).
    ``kind="poison"``: ``n`` entries set to reserved keys, alternating
    ``EMPTY_KEY`` (folded by ``sanitize_keys``, never stored raw) and 0."""
    if kind not in ("dup", "poison"):
        raise ValueError(f"corrupt_trace kind must be 'dup'|'poison', "
                         f"got {kind!r}")
    rng = rng_for(seed, f"trace.{kind}", step)
    out = np.array(trace, np.uint32)
    if out.size < 2:
        raise ValueError("corrupt_trace: trace too short")
    pos = rng.choice(np.arange(1, out.size), size=min(n, out.size - 1),
                     replace=False)
    if kind == "dup":
        out[pos] = out[pos - 1]
    else:
        out[pos] = np.where(np.arange(pos.size) % 2 == 0,
                            np.uint32(EMPTY_KEY), np.uint32(0))
    report = FaultReport(kind=kind, site="trace",
                         index=tuple(int(p) for p in np.sort(pos)), bit=-1,
                         before=float("nan"), after=float("nan"),
                         seed=seed, step=step)
    return out, report

