"""Two-level replay hierarchy: an exclusive L1 over the L2 cache (torch).

Counterpart of ``repro/core/hierarchy.py`` (DESIGN.md §14).  The reference
packs each tier into ``[S, 7·128]`` rows with a scalar mailbox and walks
lanes in even/odd half-steps: devices against XLA's copy elision.  The port
keeps the semantics, not that layout: both tiers are ordinary
``KWayState``s, and ``replay_l1_over_l2`` (the plain version of Hopper
kernel 4, ``kernels/csrc/replay_hier.cu``) runs each lane's phases in
straight line, which the reference documents as bit-equivalent.

Per lane, in trace order (lane i sees lane i-1's moves):

  A. probe the L1 row ``s1`` (salted hash ``seed ^ L1_SEED_SALT``); a hit
     of an enabled lane applies ``on_hit`` at ``t_get = base + i``;
  B. probe the L2 row ``s2``; ``l2_hit = ~hit1 & hit2`` (raw: not masked by
     ``enabled``).  An enabled L2 hit applies ``on_hit`` — carried by the
     promoted entry, whose L2 slot is cleared, or in place without
     ``promote``;
  C. an enabled full miss (or a promotion) inserts into the L1 row's
     policy victim at ``t_put = base + B + i``: a fresh ``on_insert`` entry
     (payload ``val == key``), or the promoted entry with its value,
     metadata and deadline;
  D. with ``demote``, the displaced L1 entry moves into ITS OWN L2 set (the
     set of its stored key ``dk``, metadata and deadline carried), onto that
     row's victim at ``t_put``; without ``demote`` it is dropped.

An eviction counts when an entry leaves both tiers: a demotion onto an
occupied L2 victim, or a displaced entry dropped without ``demote``.  The
clock advances by 2B per chunk on both tiers.

With ``ttls`` every row the reference fetches is scrubbed at the chunk-exit
horizon ``base + 2B`` before it is read — phase A's and B's rows even on a
hit or for a disabled lane, and phase D's row of ``dk`` even when nothing is
demoted (``dk`` may be EMPTY, hashed like any key).  There is no eager
scrub of rows no lane touches.  Without ``demote`` phase D fetches nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import (NEG_INF, NO_EXPIRY, STATE_LANES,
                                   KWayConfig, KWayState, ensure_expiry,
                                   make_cache, state_from_numpy,
                                   state_to_numpy)
from repro_torch.core.policies import Policy, victim_scores

__all__ = ["L1_SEED_SALT", "HierarchyConfig", "HierState", "l1_config",
           "make_hier", "as_hier_state", "hier_from_numpy", "hier_to_numpy",
           "replay_l1_over_l2"]

#: XOR salt for the L1 set hash — decorrelates the two tiers' set mappings.
L1_SEED_SALT = 0x7A11

#: widest L1 set (the reference's 128-lane row)
_MAX_WAYS = 128


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Static L1-over-L2 configuration.  ``l1_sets == 0`` means no
    hierarchy: callers take the flat replay paths unchanged."""

    l1_sets: int
    l1_ways: int = 16
    promote: bool = True
    demote: bool = True

    def __post_init__(self):
        assert self.l1_sets >= 0
        assert self.l1_sets == 0 or self.l1_sets & (self.l1_sets - 1) == 0, \
            "l1_sets must be 0 or a power of two"
        assert 1 <= self.l1_ways <= _MAX_WAYS

    @property
    def enabled(self) -> bool:
        return self.l1_sets > 0

    @property
    def l1_capacity(self) -> int:
        return self.l1_sets * self.l1_ways


@dataclasses.dataclass
class HierState:
    """The hierarchy's contents: two k-way states sharing one clock
    (``l2.clock`` is authoritative on entry)."""

    l1: KWayState
    l2: KWayState

    def occupancy(self) -> torch.Tensor:
        return self.l1.occupancy() + self.l2.occupancy()


def l1_config(cfg: KWayConfig, hier: HierarchyConfig) -> KWayConfig:
    """The L1 tier as a plain KWayConfig (same policy, salted set seed)."""
    return KWayConfig(num_sets=hier.l1_sets, ways=hier.l1_ways,
                      policy=cfg.policy, layout=cfg.layout,
                      seed=cfg.seed ^ L1_SEED_SALT)


def make_hier(cfg: KWayConfig, hier: HierarchyConfig, *, device,
              ttl: bool = False) -> HierState:
    """An empty hierarchy; ``ttl=True`` gives both tiers an expiry lane."""
    return HierState(l1=make_cache(l1_config(cfg, hier), device=device,
                                   ttl=ttl),
                     l2=make_cache(cfg, device=device, ttl=ttl))


def as_hier_state(cfg: KWayConfig, hier: HierarchyConfig, state, *,
                  ttl: bool = False) -> HierState:
    """A ``HierState`` passes through; a bare L2 ``KWayState`` gets an empty
    L1.  ``ttl=True`` ensures both tiers carry the expiry lane."""
    if isinstance(state, HierState):
        if ttl:
            return HierState(l1=ensure_expiry(state.l1),
                             l2=ensure_expiry(state.l2))
        return state
    ttl = ttl or state.expiry is not None
    return HierState(
        l1=make_cache(l1_config(cfg, hier), device=state.device, ttl=ttl),
        l2=ensure_expiry(state) if ttl else state)


def hier_from_numpy(arrays: dict, *, device) -> HierState:
    """A reference ``HierState`` as ``{"l1": leaves, "l2": leaves}`` (each
    as ``kway.state_from_numpy`` takes them; a sharded stack's leading
    axis carries over) -> port state."""
    return HierState(l1=state_from_numpy(arrays["l1"], device=device),
                     l2=state_from_numpy(arrays["l2"], device=device))


def hier_to_numpy(state: HierState) -> dict:
    """Port ``HierState`` -> ``{"l1": leaves, "l2": leaves}`` in the
    reference's layout."""
    return {"l1": state_to_numpy(state.l1), "l2": state_to_numpy(state.l2)}


def carried_tiers(state: HierState, ttl: bool) -> HierState:
    """The tiers a replay works on: both with an expiry lane if either has
    one or ``ttl`` (the reference's packed rows always carry the section)."""
    if ttl or state.l1.expiry is not None or state.l2.expiry is not None:
        return HierState(l1=ensure_expiry(state.l1),
                         l2=ensure_expiry(state.l2))
    return state


def _i32(x: int) -> int:
    """Wrap a Python int to int32, as the reference's clock arithmetic."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


# ---------------------------------------------------------------------------
# the plain version of kernel 4: one lane at a time, rows as tensor views
# ---------------------------------------------------------------------------

class _Tier:
    """A tier's lanes (copies, written in place) and its row arithmetic."""

    def __init__(self, st: KWayState, policy: Policy):
        self.lanes = [getattr(st, f).clone() for f in STATE_LANES]
        self.exp = None if st.expiry is None else st.expiry.clone()
        self.policy = policy

    def row(self, s: int):
        """Views of set ``s``: [keys, fprint, vals, meta_a, meta_b, expiry
        or None]."""
        return [t[s] for t in self.lanes] + [
            None if self.exp is None else self.exp[s]]

    @staticmethod
    def scrub(r, horizon: int) -> None:
        dead = (r[0] != EMPTY) & (r[5] <= horizon)
        for t, v in zip(r, (EMPTY, 0, 0, 0, 0, NO_EXPIRY)):
            t.masked_fill_(dead, v)

    @staticmethod
    def probe(r, qk: int, fp: int):
        """-> (hit, first matching way or -1)."""
        eq = (r[0] == qk) & (r[1] == fp) & (r[0] != EMPTY)
        w = int(eq.to(torch.int8).argmax())
        return (True, w) if bool(eq[w]) else (False, -1)

    def victim(self, r, now: int) -> int:
        """Policy victim at ``now``: empty ways first, ties to the lowest
        way."""
        sc = victim_scores(self.policy, r[3], r[4], now, r[0])
        sc = torch.where(r[0] == EMPTY, torch.full_like(sc, NEG_INF), sc)
        return int(sc.argmin())

    @staticmethod
    def read(r, w: int):
        return [int(t[w]) if t is not None else NO_EXPIRY for t in r]

    @staticmethod
    def write(r, w: int, vals) -> None:
        """Write way ``w``; a ``None`` value leaves its lane as it is."""
        for t, v in zip(r, vals):
            if t is not None and v is not None:
                t[w] = v

    def state(self, clock: torch.Tensor) -> KWayState:
        return KWayState(*self.lanes, clock=clock, expiry=self.exp)


def _hit_meta(policy: Policy, a: int, b: int, now: int):
    """``policies.on_hit`` on one way."""
    if policy == Policy.LRU:
        return now, b
    if policy in (Policy.LFU, Policy.HYPERBOLIC):
        return _i32(a + 1), b
    return a, b


def _insert_meta(policy: Policy, now: int):
    """``policies.on_insert`` on one way."""
    if policy in (Policy.LRU, Policy.FIFO):
        return now, 0
    if policy == Policy.LFU:
        return 1, 0
    if policy == Policy.RANDOM:
        return 0, 0
    return 1, now                      # HYPERBOLIC: (n=1, t0=now)


def replay_l1_over_l2(cfg: KWayConfig, hier: HierarchyConfig,
                      state: HierState, chunks, enabled, ttls=None):
    """Replay ``chunks`` uint32 [T, B] / ``enabled`` bool [T, B] (the
    ``router.pad_chunks`` layout, payload ``val == key``) through the
    hierarchy, lane by lane (see the module docstring).  ``ttls`` int32
    [T, B] turns on expiry: a miss inserts with deadline ``base + 2B + ttl``
    (``ttl <= 0``: never) and fetched rows are scrubbed lazily.

    The plain version of kernel 4: per-chunk counts and both final tiers
    equal the reference's ``replay_l1_over_l2`` and the kernel bit for bit.
    -> (hits int32 [T], evs int32 [T], HierState', None)."""
    if not hier.enabled:
        raise ValueError("replay_l1_over_l2 needs l1_sets > 0")
    ttl = ttls is not None
    state = carried_tiers(state, ttl)
    dev = state.l2.device
    qk = hashing.sanitize_keys(hashing.key_tensor(chunks, dev).cpu())
    steps, batch = qk.shape
    s1 = hashing.set_index(qk, hier.l1_sets, cfg.seed ^ L1_SEED_SALT).tolist()
    s2 = hashing.set_index(qk, cfg.num_sets, cfg.seed).tolist()
    fps = hashing.fingerprint(qk).tolist()
    qk = qk.tolist()
    en_all = torch.as_tensor(enabled, dtype=torch.bool).cpu().tolist()
    tt_all = (torch.as_tensor(ttls, dtype=torch.int32).cpu().tolist()
              if ttl else None)

    policy = cfg.policy
    t1, t2 = _Tier(state.l1, policy), _Tier(state.l2, policy)
    seed, l2_mask = cfg.seed, cfg.num_sets - 1
    hits = [0] * steps
    evs = [0] * steps
    clock0 = int(state.l2.clock)
    for t in range(steps):
        base = _i32(clock0 + 2 * batch * t)
        horizon = _i32(base + 2 * batch)
        for i in range(batch):
            q, fp, en = qk[t][i], fps[t][i], en_all[t][i]
            t_get, t_put = _i32(base + i), _i32(base + batch + i)
            r1, r2 = t1.row(s1[t][i]), t2.row(s2[t][i])
            if ttl:
                t1.scrub(r1, horizon)
                t2.scrub(r2, horizon)
                tt = tt_all[t][i]
                dl = _i32(horizon + tt) if tt > 0 else NO_EXPIRY
            else:
                dl = NO_EXPIRY

            # A: L1 hit
            hit1, w1 = t1.probe(r1, q, fp)
            if hit1 and en:
                _, _, _, a, b, _ = t1.read(r1, w1)
                t1.write(r1, w1, (None, None, None)
                         + _hit_meta(policy, a, b, t_get))

            # B: L2 hit, promoted or updated in place
            hit2, w2 = t2.probe(r2, q, fp)
            l2_hit = hit2 and not hit1
            if l2_hit:
                _, _, pval, a, b, pexp = t2.read(r2, w2)
                pa, pb = _hit_meta(policy, a, b, t_get)
                if en and hier.promote:
                    t2.write(r2, w2, (EMPTY, 0, 0, 0, 0, NO_EXPIRY))
                elif en:
                    t2.write(r2, w2, (None, None, None, pa, pb))

            # C: L1 fill, displacing the L1 victim
            ins = en and not hit1 and (hier.promote or not l2_hit)
            dvalid = False
            if ins or (ttl and hier.demote):
                vw = t1.victim(r1, t_put)
                disp = t1.read(r1, vw)
                dvalid = ins and disp[0] != EMPTY
                if ins:
                    if l2_hit:
                        new = (q, fp, pval, pa, pb, pexp)
                    else:
                        new = (q, fp, q) + _insert_meta(policy, t_put) + (dl,)
                    t1.write(r1, vw, new)

                # D: demote the displaced entry into its own L2 set
                if hier.demote:
                    dk = disp[0]
                    r2v = t2.row(hashing.hash_u32_int(dk, seed) & l2_mask)
                    if ttl:
                        t2.scrub(r2v, horizon)
                    if dvalid:
                        vw2 = t2.victim(r2v, t_put)
                        evs[t] += int(r2v[0][vw2]) != EMPTY
                        t2.write(r2v, vw2, disp)
                else:
                    evs[t] += dvalid
            hits[t] += en and (hit1 or l2_hit)

    clock = state.l2.clock + 2 * batch * steps

    def counts(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return (counts(hits), counts(evs),
            HierState(l1=t1.state(clock.clone()), l2=t2.state(clock)), None)
