"""Public wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``: shape the kernel inputs and call
the kernel wrappers, which run the kernel for CUDA tensors and the plain
version for CPU tensors.  The probes (kernels 1 and 2) route the keys
themselves, so their ops are one wrapper call each.  Ways are not padded to
128 lanes: that was the TPU's register width.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.kway import KWayConfig, KWayState
from repro_torch.kernels import kway_probe as _kp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import replay as _rp


def _probe(cfg: KWayConfig, state: KWayState, qkeys, **kw):
    return _kp.kway_probe(state.keys, state.fprint, state.meta_a,
                          state.meta_b, qkeys, state.clock,
                          num_sets=cfg.num_sets, seed=cfg.seed,
                          policy=cfg.policy, **kw)


def probe(cfg: KWayConfig, state: KWayState, qkeys):
    """Probe int32 key lanes -> (qkeys_sanitized, sets, hit bool[B], way,
    victim_way, victim_key)."""
    return _probe(cfg, state, qkeys)


def probe_hits(cfg: KWayConfig, state: KWayState, qkeys):
    """Read-path probe, no victim scoring -> (qkeys, sets, hit, way)."""
    return _probe(cfg, state, qkeys, need_victims=False)


def probe_orders(cfg: KWayConfig, state: KWayState, qkeys):
    """Probe + full victim order (what ``kway.apply_put`` consumes) ->
    (qkeys, sets, hit, way, order [B, ways])."""
    qk, sets, hit, way, _, _, order = _probe(cfg, state, qkeys,
                                             full_order=True)
    return qk, sets, hit, way, order


def fused_probe(cfg: KWayConfig, state: KWayState, qkeys, enabled=None):
    """Fused probe for ``access`` -> (qkeys, sets, hit bool[B] raw, way,
    order [B, ways]) with the order scored on the hit-updated metadata at
    the put-phase times: what ``kway.apply_access`` consumes.  ``enabled``
    is a bool [B] tensor on the state's device, or None."""
    return _kp.kway_fused_probe(state.keys, state.fprint, state.meta_a,
                                state.meta_b, qkeys, state.clock, enabled,
                                num_sets=cfg.num_sets, seed=cfg.seed,
                                policy=cfg.policy)


def replay_resident(cfg: KWayConfig, state: KWayState, chunks, enabled,
                    ttls=None, tinylfu=None, sketch=None):
    """Whole-trace replay in ONE kernel launch (kernel 3).  ``chunks``
    uint32 keys [steps, B] and ``enabled`` bool [steps, B] in the
    ``router.pad_chunks`` layout, optional ``ttls`` int32 [steps, B], or
    TinyLFU admission (``tinylfu`` and an optional ``sketch``).
    -> (hits int32 [steps], evs int32 [steps], state', sketch' or None)."""
    dev = state.device
    qkeys, enabled, ttls = _chunk_tensors(chunks, enabled, ttls, dev)
    return _rp.replay_resident(cfg, state, qkeys, enabled, ttls,
                               tinylfu=tinylfu, sketch=sketch)


def replay_hierarchical(cfg: KWayConfig, hier, state, chunks, enabled,
                        ttls=None):
    """Whole-trace replay through the L1-over-L2 hierarchy in ONE kernel
    launch (kernel 4).  ``state`` is a ``HierState``; ``chunks`` /
    ``enabled`` / ``ttls`` as for ``replay_resident``.  Keys are sanitized
    in torch; the kernel hashes them to their sets (``seed ^ L1_SEED_SALT``
    over ``l1_sets``, ``seed`` over ``num_sets``), as it must for every
    demoted key.
    -> (hits int32 [steps], evs int32 [steps], HierState', None)."""
    dev = state.l2.device
    qkeys, enabled, ttls = _chunk_tensors(chunks, enabled, ttls, dev)
    return _rp.replay_hierarchical(cfg, hier, state, qkeys, enabled, ttls)


def _chunk_tensors(chunks, enabled, ttls, dev):
    """Chunked host or device arrays -> (int32 keys, bool flags, int32 TTLs
    or None) on ``dev``."""
    qkeys = hashing.key_tensor(chunks, dev)
    enabled = torch.as_tensor(enabled, dtype=torch.bool).to(dev)
    if ttls is not None:
        ttls = torch.as_tensor(ttls, dtype=torch.int32).to(dev)
    return qkeys, enabled, ttls


def attend_paged(q, k_pages, v_pages, page_table, seq_lens, *, scale=None,
                 softcap: float = 0.0):
    """Paged GQA decode attention (kernel 5; see
    ``kernels/paged_attention.py``): the kernel for CUDA tensors, the plain
    version for CPU tensors, and any other device raises."""
    return _pa.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               scale=scale, softcap=softcap)
