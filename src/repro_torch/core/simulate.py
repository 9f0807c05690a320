"""Trace replay — the hit-ratio study engine (paper §5.2), in torch.

Counterpart of ``repro/core/simulate.py``.  ``replay`` is the exact
sequential replay (batch size 1); ``replay_batched`` replays B requests per
step with the deterministic conflict resolution of ``kway.access``, flat,
``resident=True`` (``CacheBackend.replay``: kernel 3 on the ``cuda``
backend, one launch for the whole trace), with per-request ``ttls``, with
TinyLFU admission (``SimConfig.tinylfu``) or through the L1-over-L2
``hierarchy`` (kernel 4 on ``cuda``), and with ``shards > 1`` through the
set-sharded layer (``core/sharded.py``: D kernel-3 launches when resident).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import admission, kway, router
from repro_torch.core.admission import TinyLFUConfig
from repro_torch.core.backend import (HIER_TINYLFU, REF_HIER, REF_TINYLFU,
                                      make_backend, resolve_device)
from repro_torch.core.kway import KWayConfig


@dataclasses.dataclass(frozen=True)
class SimConfig:
    cache: KWayConfig
    tinylfu: Optional[TinyLFUConfig] = None   # None: admit always
    backend: str = "cuda"
    # True: replay through the unfused get-then-put composition
    # (backend.access_two_phase), the oracle of the fused access.
    two_phase: bool = False
    device: Optional[str] = None       # None: the card

    def __post_init__(self):
        resolve_device(self.device)


def _access_fn(sim: SimConfig, be):
    return be.access_two_phase if sim.two_phase else be.access


def _pad_ttl_chunks(ttls: np.ndarray, batch: int) -> np.ndarray:
    """Chunk a per-request TTL array [n] -> int32 [steps, B] with the
    ``router.pad_chunks`` geometry (padding lanes carry ttl 0 == never
    expires; they are disabled anyway)."""
    ttls = np.asarray(ttls, np.int32)
    n = ttls.shape[0]
    steps = -(-n // batch)
    padded = np.zeros((steps * batch,), np.int32)
    padded[:n] = ttls
    return padded.reshape(steps, batch)


def _replay_chunks(sim: SimConfig, chunks, enabled, tchunks=None) -> int:
    """Chunked loop through the backend's (fused or two-phase) access, with
    TinyLFU's record -> peek -> admit per chunk when configured -> total
    hits."""
    be = make_backend(sim.backend, sim.cache, sim.device)
    keys = be.keys(chunks)
    en = torch.as_tensor(enabled).to(be.device)
    if sim.tinylfu is not None:
        hits, _, _, _ = admission.replay_chunks(
            sim.tinylfu, admission.make_sketch(sim.tinylfu, be.device),
            _access_fn(sim, be), be.peek_victims, be.init(), keys, en)
        return int(hits.sum())
    tt = None if tchunks is None else torch.from_numpy(tchunks).to(be.device)
    hits, _, _ = kway.replay_chunks(
        _access_fn(sim, be), be.init(ttl=tchunks is not None), keys, en, tt)
    return int(hits.sum())


def _refuse_ref_tinylfu(sim: SimConfig):
    if sim.tinylfu is not None and sim.backend == "ref":
        raise ValueError(REF_TINYLFU)


def replay(sim: SimConfig, trace: np.ndarray) -> float:
    """Exact sequential replay (batch size 1) -> hit ratio.  Traceable
    backends run it as a one-lane resident replay (kernel 3 on ``cuda``),
    with TinyLFU's record -> peek -> admit -> access per request when
    ``sim.tinylfu`` is set."""
    trace = np.asarray(trace, np.uint32)
    _refuse_ref_tinylfu(sim)
    chunks, enabled = router.pad_chunks(trace, 1)
    if sim.backend == "ref" or sim.two_phase:
        return _replay_chunks(sim, chunks, enabled) / trace.shape[0]
    be = make_backend(sim.backend, sim.cache, sim.device)
    hits, _, _, _ = be.replay(be.init(), chunks, enabled,
                              tinylfu=sim.tinylfu)
    return int(hits.sum()) / trace.shape[0]


def replay_batched(sim: SimConfig, trace: np.ndarray, batch: int = 64,
                   shards: int = 1, resident: bool = False, hierarchy=None,
                   ttls=None) -> float:
    """Batched replay -> hit ratio over the WHOLE trace (the tail chunk is
    padded with disabled lanes).

    ``resident=True`` replays through ``CacheBackend.replay``: on the
    ``cuda`` backend kernel 3, the whole trace in one launch, bit-identical
    to the chunked loop.  ``sim.tinylfu`` gates each miss by TinyLFU
    admission (record -> peek -> admit per chunk; kernel 3's TinyLFU branch
    when resident).  ``ttls`` (int32 [n], aligned with ``trace``) gives
    each request a time-to-live on the logical clock: a missing request
    inserts with deadline ``clock + 2B + ttl`` (``ttl <= 0``: never), and
    an expired entry is never a hit.  TTL replays run through
    ``CacheBackend.replay`` as in the reference.

    ``hierarchy`` (a ``HierarchyConfig`` with ``l1_sets > 0``) replays
    through the exclusive L1-over-L2 hierarchy (kernel 4 on ``cuda``, its
    plain version on ``torch``), with or without ``ttls``; ``l1_sets == 0``
    is the flat path unchanged.  The hierarchy takes no TinyLFU and no
    ``two_phase``, as in the reference.

    ``shards > 1`` replays through ``core/sharded.py``'s ``ShardedCache``:
    routing on the device, per-shard TinyLFU sketches, ``two_phase``,
    ``ttls`` and ``resident`` all compose with it (the hierarchy runs
    resident, one kernel-4 launch per shard); only the sequential ``ref``
    oracle cannot be sharded.
    """
    trace = np.asarray(trace, np.uint32)
    n = trace.shape[0]
    _refuse_ref_tinylfu(sim)
    if ttls is not None:
        ttls = np.asarray(ttls, np.int32)
        if ttls.shape[0] != n:
            raise ValueError(
                f"ttls length {ttls.shape[0]} != trace length {n}")
        if sim.two_phase:
            raise ValueError(
                "per-request TTLs require the fused access path; "
                "two_phase has no expiry semantics")
        if sim.tinylfu is not None:
            raise ValueError(admission.TTL_EXCLUSIVE)
    if hierarchy is not None and not hierarchy.enabled:
        hierarchy = None          # l1_sets == 0: the flat path, verbatim
    if hierarchy is not None:
        if sim.backend == "ref":
            raise ValueError(REF_HIER)
        if sim.two_phase:
            raise ValueError(
                "hierarchical replay is the fused sequential-lane path; "
                "two_phase does not compose with it")
        if sim.tinylfu is not None:
            raise ValueError(HIER_TINYLFU)
    if resident:
        if sim.backend == "ref":
            raise ValueError(
                "the ref backend is sequential host Python; the resident "
                "replay needs 'torch' or 'cuda'")
        if sim.two_phase:
            raise ValueError(
                "resident replay is the fused access path; two_phase is the "
                "chunked oracle — replay with resident=False")
    if shards > 1:
        if sim.backend == "ref":
            raise ValueError(
                "the ref backend is sequential host Python and cannot be "
                "sharded; use backend='torch' or 'cuda' with shards > 1")
        from repro_torch.core.sharded import ShardedCache, ShardedConfig
        sc = ShardedCache(ShardedConfig(cache=sim.cache, num_shards=shards,
                                        backend=sim.backend),
                          device=sim.device)
        hits, _, _ = sc.replay(trace, batch, tinylfu=sim.tinylfu,
                               two_phase=sim.two_phase,
                               resident=resident or hierarchy is not None,
                               hierarchy=hierarchy, ttls=ttls)
        return hits / n
    chunks, enabled = router.pad_chunks(trace, batch)
    tchunks = None if ttls is None else _pad_ttl_chunks(ttls, batch)
    if (hierarchy is not None or resident
            or (tchunks is not None and sim.backend != "ref")):
        be = make_backend(sim.backend, sim.cache, sim.device)
        hits, _, _, _ = be.replay(be.init(ttl=tchunks is not None), chunks,
                                  enabled, tinylfu=sim.tinylfu,
                                  hierarchy=hierarchy, ttls=tchunks)
        return int(hits.sum()) / n
    return _replay_chunks(sim, chunks, enabled, tchunks) / n
