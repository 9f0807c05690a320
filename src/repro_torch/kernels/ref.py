"""Plain torch versions of the probe kernels and of paged attention.

Counterpart of ``repro/kernels/ref.py``: each function computes exactly
what its CUDA kernel computes (``kernels/csrc/kway_probe.cu``,
``kernels/csrc/paged_attention.cu``), with plain tensor ops.  The probes
take the raw key lanes and route them themselves (sanitize, set index,
times), as their kernels do.  The CPU
tests use them, the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds the kernels to them on the card.

Lanes are ``[S, ways]`` int32, unpadded: the reference padded ways to the
TPU's 128-lane register width, which the port has no use for.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import NEG_INF
from repro_torch.core.policies import Policy, victim_scores

_I32_LOW = -(2**31 - 1)


def route(qkeys, clock, num_sets: int, seed: int):
    """What kernels 1 and 2 compute before probing: the sanitized keys
    (int32), their sets (int64) and the get-phase times ``clock + i``
    (int32, wrapping)."""
    qk = hashing.sanitize_keys(qkeys)
    sets = hashing.set_index(qk, num_sets, seed)
    times = clock + torch.arange(qk.shape[0], dtype=torch.int32,
                                 device=qk.device)
    return qk, sets, times


def _row_probe(keys, fprint, sets, qkeys):
    """Fingerprint pre-filter + full-key confirm on each query's set row.
    -> (row_keys [B, k], occupied [B, k], hit [B], way [B] int64: first
    match or 0)."""
    row_keys = keys[sets]
    occupied = row_keys != EMPTY
    eq = ((fprint[sets] == hashing.fingerprint(qkeys)[:, None])
          & (row_keys == qkeys[:, None]) & occupied)
    hit = eq.any(dim=-1)
    way = torch.where(hit, eq.to(torch.int8).argmax(dim=-1),
                      torch.zeros_like(sets))
    return row_keys, occupied, hit, way


def _order(policy, row_keys, occupied, row_a, row_b, now):
    """Worst-victim-first order of each row (empty ways first, ties to the
    lowest way), int64 [B, k]."""
    sc = victim_scores(policy, row_a, row_b, now[:, None], row_keys)
    sc = torch.where(occupied, sc, torch.full_like(sc, NEG_INF))
    return torch.argsort(sc, dim=-1, stable=True)


def kway_probe_ref(keys, fprint, meta_a, meta_b, qkeys, clock, *,
                   num_sets, seed, policy, full_order=False,
                   need_victims=True):
    """Plain version of ``kway_probe.kway_probe``: route the raw int32 key
    lanes ``qkeys`` [B] (``route``), probe, and score at ``clock + i``.

    -> (qk int32, sets int64, hit bool, way int64) [B] when
    ``need_victims`` is False; else also the victim way (int64) and key
    (int32) [B], and with ``full_order`` the whole worst-victim-first order
    int32 [B, ways].
    """
    qk, sets, times = route(qkeys, clock, num_sets, seed)
    row_keys, occupied, hit, way = _row_probe(keys, fprint, sets, qk)
    out = (qk, sets, hit, way)
    if not need_victims:
        return out
    order = _order(policy, row_keys, occupied, meta_a[sets], meta_b[sets],
                   times)
    vway = order[:, :1]
    out = out + (vway[:, 0], torch.gather(row_keys, 1, vway)[:, 0])
    if full_order:
        out = out + (order.to(torch.int32),)
    return out


def kway_fused_probe_ref(keys, fprint, meta_a, meta_b, qkeys, clock, en, *,
                         num_sets, seed, policy):
    """Plain version of ``kway_probe.kway_fused_probe``: route the raw
    int32 key lanes ``qkeys`` [B], probe at ``clock + i`` and score the
    order on ``meta_a`` after the live hits' ``on_hit`` (``en`` bool [B],
    None: every lane) at ``clock + B + i``.  -> (qk int32, sets int64, hit
    bool [B] raw, unmasked by ``en``; way int64 [B]; order int32 [B,
    ways]).  Batched, the sequential hit transitions are a scatter-add
    (LFU/HYPERBOLIC) or scatter-max (LRU: batch times increase)."""
    qk, sets, times_get = route(qkeys, clock, num_sets, seed)
    times_put = times_get + qk.shape[0]
    row_keys, occupied, hit, way = _row_probe(keys, fprint, sets, qk)
    do = hit if en is None else hit & en
    flat = sets * keys.shape[1] + way
    ma1 = meta_a
    if policy == Policy.LRU:
        ma1 = meta_a.clone()
        src = torch.where(do, times_get, torch.full_like(times_get, _I32_LOW))
        ma1.view(-1).scatter_reduce_(0, flat, src, reduce="amax")
    elif policy in (Policy.LFU, Policy.HYPERBOLIC):
        ma1 = meta_a.clone()
        ma1.view(-1).index_put_((flat,), do.to(torch.int32), accumulate=True)
    order = _order(policy, row_keys, occupied, ma1[sets], meta_b[sets],
                   times_put)
    return qk, sets, hit, way, order.to(torch.int32)


# ---------------------------------------------------------------------------
# paged attention (kernel 5)
# ---------------------------------------------------------------------------

#: Masked-logit sentinel of the reference's oracle (finite, so a fully
#: masked row never computes exp(-inf - -inf)).
ATTN_NEG_INF = -3.0e38


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, *,
                        scale=None, softcap: float = 0.0):
    """One GQA decode step over a paged KV pool -> [B, H, D] in q's dtype.

    ``q`` [B, H, D]; ``k_pages`` / ``v_pages`` [KVH, P, page, D];
    ``page_table`` int32 [B, PPS]; ``seq_lens`` int32 [B].  Gathers each
    sequence's pages, masks positions ``>= seq_len``, softmax in f32
    (optional tanh softcap).  ``seq_len == 0`` gives zeros.
    """
    b, h, d = q.shape
    kvh, _, page, _ = k_pages.shape
    pps = page_table.shape[1]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    pt = page_table.long()
    k = k_pages[:, pt].reshape(kvh, b, pps * page, d)   # [KVH, B, T, D]
    v = v_pages[:, pt].reshape(kvh, b, pps * page, d)
    pos = torch.arange(pps * page, device=q.device)[None, :]
    mask = (pos < seq_lens[:, None].long())[:, None, None, :]  # [B,1,1,T]
    qg = q.reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,kbtd->bkgt", qg.float(), k.float()) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, torch.full_like(logits, ATTN_NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = e.sum(dim=-1, keepdim=True)
    w = e / torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bkgt,kbtd->bkgd", w, v.float())
    return o.reshape(b, h, d).to(q.dtype)
