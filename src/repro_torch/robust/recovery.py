"""Recovery paths: scrub-and-invalidate repair and engine checkpoint/restore.

Counterpart of ``repro/robust/recovery.py``.

* **Scrub** (``scrub``, ``scrub_hier``): limited associativity localizes
  damage (a bad lane can only poison its own set), so the repair resets the
  damaged sets to empty, tallied as *forced evictions*, and the replay
  continues.  Expiry violations and ``double_resident`` are lane-local and
  clear just the lane.
* **Checkpoint / restore** (``save_engine``, ``restore_engine``,
  ``CheckpointedEngine``): faults the validator cannot repair (a crashed
  tick, NaN KV pools) roll back to the last *committed* checkpoint,
  written through ``ckpt/manager.py``'s atomic-rename protocol.  The
  device-resident tick's ``ServeState`` is the tree; the host queues
  (waiting / running / finished requests) ride in the manifest's
  ``extra``.  A restore writes into the engine's static buffers in place,
  so the CUDA graphs captured at ``Engine(...)`` keep replaying the
  addresses they hold: the state is never rebound.  The host's mirror of
  the slots, ``running``, is restored with it, so the tick's choice of
  graph (admit or decode) and its drain after each ``_fetch`` continue
  where the checkpoint left off.

``validated_replay`` runs the cache validator inside the chunked replay
every ``interval`` chunks, the violation word carried as a tensor (no host
sync until the caller reads it).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import NO_EXPIRY, KWayConfig, KWayState
from repro_torch.robust import events
from repro_torch.robust.invariants import (cache_lane_bits, hier_lane_bits,
                                           or_reduce)

__all__ = ["scrub", "scrub_hier", "validated_replay", "save_engine",
           "restore_engine", "CheckpointedEngine"]

ENGINE_KIND = "repro_torch.serve.engine"

# ---------------------------------------------------------------------------
# scrub-and-invalidate
# ---------------------------------------------------------------------------

# Expiry violations (expired_hit / expired_resident) and double_resident
# are lane-local: an expired or duplicated entry cannot shadow its
# neighbours' probes, so the repair clears just that lane.  Everything
# else (flipped keys / fprints / meta) can poison the whole set's probe
# and is wiped set-granular.
_LANE_LOCAL_BITS = (1 << 6) | (1 << 7) | (1 << 8)


def _scrub_lanes(state: KWayState, lane_bits: torch.Tensor):
    """Clear violating lanes -> (state', forced_evictions int32 [])."""
    structural = lane_bits & ~_LANE_LOCAL_BITS
    bad = (structural != 0).any(1, keepdim=True) | (lane_bits != 0)
    forced = ((state.keys != EMPTY) & bad).sum(dtype=torch.int32)

    def clear(t, v):
        return torch.where(bad, torch.full_like(t, v), t)

    state = dataclasses.replace(
        state, keys=clear(state.keys, EMPTY), fprint=clear(state.fprint, 0),
        vals=clear(state.vals, 0), meta_a=clear(state.meta_a, 0),
        meta_b=clear(state.meta_b, 0),
        expiry=(None if state.expiry is None
                else clear(state.expiry, NO_EXPIRY)))
    return state, forced


def scrub(cfg: KWayConfig, state: KWayState, *, vals_mode: str = "any",
          expiry_mode: str = "strict"):
    """Reset every violating region of the cache to empty: structural
    corruption set-granular, expiry violations lane-granular (parking
    ``NO_EXPIRY``).  -> (state', forced_evictions, lane_bits) with the
    occupied lanes cleared counted and the pre-repair bitmap.  The clock
    is untouched; a clean state passes through with a zero tally."""
    lane_bits = cache_lane_bits(cfg, state, vals_mode, expiry_mode)
    state, forced = _scrub_lanes(state, lane_bits)
    return state, forced, lane_bits


def scrub_hier(cfg: KWayConfig, hier, state, *, vals_mode: str = "any"):
    """Scrub both tiers of a ``HierState``: the per-tier catalogue (lazy
    expiry mode) plus ``double_resident``, repaired by clearing the L1 copy
    (the L2 keeps the entry).  -> (state', forced_evictions, (l1_bits,
    l2_bits)), the tally summed over both tiers."""
    l1_bits, l2_bits, dbits = hier_lane_bits(cfg, hier, state, vals_mode)
    l1, f1 = _scrub_lanes(state.l1, l1_bits | dbits)
    l2, f2 = _scrub_lanes(state.l2, l2_bits)
    return (dataclasses.replace(state, l1=l1, l2=l2), f1 + f2,
            (l1_bits | dbits, l2_bits))


# ---------------------------------------------------------------------------
# replay with the validator inside the loop
# ---------------------------------------------------------------------------

def validated_replay(cfg: KWayConfig, chunks, enabled, *,
                     backend: str = "cuda", interval: int = 1, tinylfu=None,
                     state: KWayState | None = None, vals_mode: str = "key",
                     ttls=None, device=None):
    """Chunked replay (``access`` per chunk; TinyLFU record -> peek ->
    admit first) with the invariant check every ``interval`` chunks: the
    violation word is OR-ed into a device tensor, so validation adds no
    host sync.  ``ttls`` (int32 [steps, B]) replays with per-request TTLs,
    the check then covering the expiry bits; excludes ``tinylfu``.
    ``device`` defaults to the state's, else the card.

    -> (hits int32 [steps], evs int32 [steps], state', sketch' | None,
    alarm_bits int32 []); ``alarm_bits != 0`` means some checked chunk
    left the cache structurally invalid."""
    from repro_torch.core import admission, kway
    from repro_torch.core.backend import make_backend

    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    if ttls is not None and tinylfu is not None:
        raise ValueError(
            "per-request TTLs and TinyLFU admission are mutually exclusive")
    be = make_backend(backend, cfg,
                      state.device if state is not None else device)
    dev = be.device
    if state is None:
        state = be.init(ttl=ttls is not None)
    keys = be.keys(chunks)
    en = torch.as_tensor(enabled, dtype=torch.bool).to(dev)
    tt = None if ttls is None else torch.as_tensor(
        ttls, dtype=torch.int32).to(dev)
    if tt is not None:
        state = kway.ensure_expiry(state)
    sk = (admission.make_sketch(tinylfu, dev) if tinylfu is not None
          else None)
    steps = keys.shape[0]
    hits = torch.zeros(steps, dtype=torch.int32, device=dev)
    evs = torch.zeros_like(hits)
    alarm = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(steps):
        admit = None
        if tinylfu is not None:
            sk = admission.record(tinylfu, sk, keys[i], enabled=en[i])
            vk, vv = be.peek_victims(state, keys[i])
            admit = admission.admit(tinylfu, sk, keys[i], vk, vv)
        kw = {} if tt is None else {"ttls": tt[i]}
        state, hit, _, _, ev = be.access(state, keys[i], keys[i], admit,
                                         en[i], **kw)
        hits[i] = hit.sum()
        evs[i] = ev.sum()
        if i % interval == 0:
            alarm = alarm | or_reduce(cache_lane_bits(cfg, state, vals_mode))
    return hits, evs, state, sk, alarm


# ---------------------------------------------------------------------------
# engine checkpoint / restore
# ---------------------------------------------------------------------------

_REQ_FIELDS = ("rid", "max_new", "generated", "pos", "prefix_hits",
               "prefix_lookups", "done")


def _pack_request(req) -> dict:
    d = {f: getattr(req, f) for f in _REQ_FIELDS}
    d["prompt"] = [int(t) for t in np.asarray(req.prompt)]
    d["generated"] = [int(t) for t in req.generated]
    return d


def _unpack_request(d):
    from repro_torch.serve.engine import Request

    return Request(
        rid=int(d["rid"]), prompt=np.asarray(d["prompt"], np.int32),
        max_new=int(d["max_new"]), generated=list(d["generated"]),
        pos=int(d["pos"]), prefix_hits=int(d["prefix_hits"]),
        prefix_lookups=int(d["prefix_lookups"]), done=bool(d["done"]))


def _require_jitted(eng, what: str):
    if not eng.ecfg.jitted:
        raise ValueError(
            f"{what} supports the jitted engine only (its whole device "
            "state is the ServeState tree); the host-loop engine keeps "
            "state in Python objects — set EngineConfig(jitted=True)")


def save_engine(eng, root: str, step: int, *, keep_last: int = 3,
                commit: bool = True) -> str:
    """Checkpoint a jitted engine: its ``ServeState`` as the tree, the host
    queues in the manifest.  ``commit=False`` is the chaos hook: the
    leaves land on disk but the atomic rename is skipped, a crash mid-tick
    between write and commit."""
    _require_jitted(eng, "save_engine")
    from repro_torch.ckpt import manager

    if eng.device.type == "cuda":
        torch.cuda.current_stream(eng.device).wait_stream(eng._stream)
    extra = {
        "kind": ENGINE_KIND,
        "next_rid": eng._next_rid,
        "waiting": [_pack_request(r) for r in eng.waiting],
        "running": [_pack_request(r) for r in eng.running.values()],
        "finished": [_pack_request(r) for r in eng.finished.values()],
    }
    return manager.save(root, step, eng._state, extra=extra,
                        keep_last=keep_last, commit=commit)


def restore_engine(eng, root: str, step: int | None = None) -> int:
    """Restore a jitted engine from the last *committed* checkpoint (or an
    explicit ``step``), in place: the tensors of ``eng``'s ``ServeState``,
    which its captured graphs read, are overwritten and never rebound.
    Uncommitted ``.tmp`` writes are ignored: the crash-mid-tick guarantee.
    Returns the step restored."""
    _require_jitted(eng, "restore_engine")
    from repro_torch.ckpt import manager

    if step is None:
        step = manager.latest_step(root)
        if step is None:
            raise ValueError(
                f"restore_engine: no committed checkpoint under {root!r} "
                "(an uncommitted .tmp from a crashed save does not count)")
    manifest = os.path.join(root, f"step_{step:09d}", "manifest.json")
    if not os.path.exists(manifest):
        raise ValueError(
            f"no committed checkpoint step_{step:09d} under {root!r}")
    with open(manifest) as f:
        kind = json.load(f)["extra"].get("kind")
    if kind != ENGINE_KIND:
        raise ValueError(
            f"checkpoint step {step} under {root!r} is not an engine "
            f"checkpoint (kind={kind!r})")
    if eng.device.type == "cuda":
        # the graphs run on the engine's stream: the restore lands after
        # any tick in flight, and the next replay after the restore
        torch.cuda.current_stream(eng.device).wait_stream(eng._stream)
    _, extra = manager.restore(root, step, eng._state)
    if eng.device.type == "cuda":
        eng._stream.wait_stream(torch.cuda.current_stream(eng.device))
    eng._next_rid = int(extra["next_rid"])
    eng.waiting = [_unpack_request(d) for d in extra["waiting"]]
    eng.running = {r.rid: r for r in
                   (_unpack_request(d) for d in extra["running"])}
    eng.finished = {r.rid: r for r in
                    (_unpack_request(d) for d in extra["finished"])}
    return step


class CheckpointedEngine:
    """Checkpoint-cadence wrapper: every ``every`` ticks the engine state
    is committed under ``root``.  On any tick the process can die; restart
    with ``restore_engine`` (or ``.restore()``) and continue with the same
    tokens.  Each commit serializes the ``ServeState`` (the KV pools
    dominate), so ``every`` trades recovery distance against throughput."""

    def __init__(self, eng, root: str, *, every: int = 1,
                 keep_last: int = 3):
        _require_jitted(eng, "CheckpointedEngine")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.eng = eng
        self.root = root
        self.every = every
        self.keep_last = keep_last
        self.tick = 0
        self.last_committed: int | None = None

    def step(self) -> None:
        self.eng.step()
        self.tick += 1
        if self.tick % self.every == 0:
            save_engine(self.eng, self.root, self.tick,
                        keep_last=self.keep_last)
            self.last_committed = self.tick

    def run(self, max_steps: int = 10_000):
        steps = 0
        while ((self.eng.waiting or self.eng._any_running())
               and steps < max_steps):
            self.step()
            steps += 1
        return self.eng.finished

    def restore(self, step: int | None = None) -> int:
        step = restore_engine(self.eng, self.root, step)
        self.tick = step
        self.last_committed = step
        events.record(component="engine.checkpoint", reason="restore",
                      detail=f"resumed from committed tick {step}")
        return step
