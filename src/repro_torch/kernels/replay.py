"""Whole-trace replay in one launch: Hopper kernel 3 and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/replay.py`` ``replay_resident``
(flat and TTL branches) with hand-written CUDA in ``csrc/replay.cu``; see
that file for the design and its bound.  The plain version is the chunked
loop over the torch twin's ``kway.access`` (``kway.replay_chunks``, which
``CacheBackend.replay`` of the ``torch`` backend runs too), which the
kernel equals bit for bit: per-chunk hits and evictions and the final
state.

On CPU tensors ``replay_resident`` runs the plain version; on CUDA tensors
it launches the kernel or raises.  ``trace_counts()`` tallies launches by
shape, as the reference's does (there is no compilation step to count).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import kway
from repro_torch.kernels import _build
from repro_torch.kernels.kway_probe import MAX_WAYS

#: Most lanes per chunk: the chunk's lanes are staged in shared memory
#: (14 B each, within the 227 KB a block can use).
MAX_BATCH = 16384

_TRACE_COUNTS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def trace_counts() -> dict:
    """Launch tally of the replay kernel, keyed by
    ("launch", policy, S, ways, steps, batch, ttl)."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


def launches() -> int:
    """Total launches of the replay kernel since the last reset."""
    return sum(_TRACE_COUNTS.values())


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("replay")
    lib.replay_launch.argtypes = [_P] * 11 + [_I] * 5 + [_P] * 4
    lib.replay_launch.restype = _I
    return lib


def replay_ref(cfg: kway.KWayConfig, state: kway.KWayState, qkeys, enabled,
               ttls=None):
    """Plain version: the chunked loop over the torch twin's fused
    ``kway.access`` (payload ``val == key``).  ``qkeys`` int32 [T, B] raw
    keys.  -> (hits int32 [T], evs int32 [T], state')."""
    return kway.replay_chunks(functools.partial(kway.access, cfg), state,
                              qkeys, enabled, ttls)


def replay_resident(cfg: kway.KWayConfig, state: kway.KWayState, qkeys,
                    enabled, ttls=None):
    """Replay ``qkeys`` int32 [T, B] (raw key bit patterns) with lane mask
    ``enabled`` bool [T, B] and optional ``ttls`` int32 [T, B].  A state
    with an expiry lane keeps it (inserts without a TTL never expire).
    -> (hits int32 [T], evs int32 [T], state')."""
    dev = state.device
    if dev.type == "cpu":
        return replay_ref(cfg, state, qkeys, enabled, ttls)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    steps, batch = qkeys.shape
    if not 1 <= cfg.ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}], got {cfg.ways}")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch must be in [1, {MAX_BATCH}], got {batch}")
    if 2 * steps * batch >= 2**31:
        raise ValueError("the replay clock would pass 2^31: trace too long")
    if enabled.shape != qkeys.shape or (ttls is not None
                                        and ttls.shape != qkeys.shape):
        raise ValueError("enabled and ttls must match the [T, B] key chunks")
    if ttls is not None:
        state = kway.ensure_expiry(state)

    # routing stays in torch: sanitize + set index, as the probe path does
    qk, sets = kway.route(cfg, qkeys.reshape(-1))
    qk = qk.contiguous()
    sets = sets.to(torch.int32).contiguous()
    en = enabled.reshape(-1).to(device=dev, dtype=torch.bool).contiguous()
    tt = (None if ttls is None
          else ttls.reshape(-1).to(device=dev, dtype=torch.int32).contiguous())
    lanes = {f: getattr(state, f).contiguous().clone()
             for f in kway.STATE_LANES}
    exp = None if state.expiry is None else state.expiry.contiguous().clone()
    for t in (*lanes.values(), exp):
        if t is not None and (t.dtype != torch.int32
                              or t.shape != (cfg.num_sets, cfg.ways)):
            raise ValueError("state lanes must be int32 [S, ways]")
    winner = torch.full((cfg.num_sets * cfg.ways,), -1, dtype=torch.int32,
                        device=dev)
    hits = torch.empty(steps, dtype=torch.int32, device=dev)
    evs = torch.empty_like(hits)
    clock = state.clock.to(torch.int32).reshape(1).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _lib().replay_launch(
        ptr(lanes["keys"]), ptr(lanes["fprint"]), ptr(lanes["vals"]),
        ptr(lanes["meta_a"]), ptr(lanes["meta_b"]), ptr(exp), ptr(clock),
        ptr(qk), ptr(sets), ptr(en), ptr(tt), steps, batch, cfg.ways,
        cfg.num_sets, int(cfg.policy), ptr(winner), ptr(hits), ptr(evs),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_resident")
    _TRACE_COUNTS[("launch", int(cfg.policy), cfg.num_sets, cfg.ways, steps,
                   batch, exp is not None)] += 1
    out = dataclasses.replace(
        state, **lanes, expiry=exp,
        clock=state.clock + 2 * batch * steps)
    return hits, evs, out
