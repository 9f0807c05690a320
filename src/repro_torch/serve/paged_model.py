"""Model entry points of the paged serving engine (port).

Counterpart of ``repro/serve/paged_model.py``:

  * ``prefill_with_kv`` — forward over prompt tokens returning last-token
    logits AND the per-layer K/V [L, B, S, KVH, D], to be written into the
    page pool at the slots the k-way cache assigned;
  * ``prefill_padded``  — the fixed-width form: tokens padded to a static
    width, logits read at ``length - 1`` (causal attention makes real-token
    outputs independent of the padding);
  * ``write_pages``     — write whole-page prefill K/V into the pool;
  * ``decode_paged``    — one decode token per sequence, attending through
    the page table with kernel 5 (``ops.attend_paged``) and writing the new
    token's K/V into its current private page;
  * ``write_pages_sink`` / ``decode_paged_sink`` — the same two pool
    writers with no host sync, for the device-resident tick that a CUDA
    graph captures: the lanes the host-loop forms leave out (by a boolean
    index or ``nonzero``, which sync) write a *sink* page at the end of
    the pool instead, which no page table names.

The pool layout is [L, KVH, P, page, D], so ``pool_k[l]`` is the
contiguous [KVH, P, page, D] slice kernel 5 reads.  Unlike the reference
(immutable arrays), the writers update the pools in place: a copy of a
4 GB pool per call would double its memory.  Lanes the reference routes
out of bounds (dropped by its scatter) are masked out or sent to the sink,
never clamped.  The decode attends globally on every layer, as the
reference does: it ignores the sliding window (gemma2's local layers),
which the prefill honours.  A config with experts runs ``layers.moe`` in
place of the MLP in both (its dispatch is fixed-shape, with a sink row for
dropped pairs, so the tick's graphs capture it).  For hymba the prefill
runs the block's SSD heads beside attention, as the reference's does
through ``lm._block_seq``, while the decode runs attention alone (the
reference's paged decode has no SSD state): a quirk copied as it is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import lm


def _logits(cfg: ModelConfig, model: lm.LM, x) -> torch.Tensor:
    """Final norm, head and final softcap of [B, d] hidden states ->
    float32 logits [B, Vp]."""
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    # the reference's bf16 head product is cast to float32 at once, which
    # XLA folds into a float32 product: no bf16 rounding of the logits
    logits = x.float() @ model.head().float()
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _embed(cfg: ModelConfig, model: lm.LM, tokens) -> torch.Tensor:
    """Embedding rows times ``scale_emb`` rounded to bf16, as the reference
    multiplies (a Python float keeps the host free of a device copy)."""
    scale = float(torch.tensor(cfg.scale_emb, dtype=torch.bfloat16))
    return model.embed[tokens.long()] * scale


@torch.no_grad()
def prefill_padded(cfg: ModelConfig, model: lm.LM, tokens, length=None):
    """Forward over (possibly padded) prompt tokens int32 [B, S]; ``length``
    int32 [B] (None: the full width).  -> (logits float32 [B, Vp] at
    position length-1, k, v [L, B, S, KVH, D])."""
    x = _embed(cfg, model, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    ks, vs = [], []
    for block, window in zip(model.blocks, lm.layer_windows(cfg)):
        x, (k, v) = block.seq(cfg, x, positions, window)
        ks.append(k)
        vs.append(v)
    if length is None:
        xl = x[:, -1]
    else:
        last = (torch.as_tensor(length, device=x.device).long() - 1).clamp(
            0, s - 1)
        xl = x[torch.arange(b, device=x.device), last]
    return _logits(cfg, model, xl), torch.stack(ks), torch.stack(vs)


def prefill_with_kv(cfg: ModelConfig, model: lm.LM, tokens):
    """Run the prompt; -> (logits at the last position [B, Vp], k, v
    [L, B, S, KVH, D])."""
    return prefill_padded(cfg, model, tokens)


def _last_lanes(flat: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The ``ok`` lanes whose page id no later ``ok`` lane repeats: the
    last-write-wins outcome of the reference's sequential scatter.  Fixed
    shape (an O(n^2) mask), so it needs no host sync."""
    order = torch.arange(flat.numel(), device=flat.device)
    later = (flat[None, :] == flat[:, None]) & ok[None, :] \
        & (order[None, :] > order[:, None])
    return ok & ~later.any(dim=1)


def _page_blocks(src: torch.Tensor, page: int) -> torch.Tensor:
    """K or V [L, B, S, KVH, D] -> whole pages [L, KVH, B * S // page,
    page, D], the pool's layout."""
    lnum, b, s, kvh, d = src.shape
    return src.reshape(lnum, b * (s // page), page, kvh, d).movedim(3, 1)


@torch.no_grad()
def write_pages(cfg: ModelConfig, kv, slots, pool_k, pool_v, valid):
    """Write prefill K/V into whole pool pages, in place.

    ``kv``: (k, v) [L, B, S, KVH, D] with S a multiple of the page size;
    ``slots`` [B, S // page] page ids (-1: skip); ``valid`` bool, same
    shape.  Skipped lanes write nothing.  A page id may repeat within one
    call when a prompt's own miss evicts one of its own hit blocks (a set
    full of the prompt's hits); then the last block in order wins, as the
    reference's sequential scatter on the CPU gives.  -> (pool_k, pool_v).
    """
    page = pool_k.shape[3]
    flat = slots.reshape(-1).to(pool_k.device).long()
    keep = _last_lanes(flat, (flat >= 0)
                       & valid.reshape(-1).to(pool_k.device))
    idx = flat[keep]
    for src, pool in ((kv[0], pool_k), (kv[1], pool_v)):
        pool[:, :, idx] = _page_blocks(src, page)[:, :, keep].to(pool.dtype)
    return pool_k, pool_v


@torch.no_grad()
def write_pages_sink(cfg: ModelConfig, kv, slots, pool_k, pool_v, valid):
    """``write_pages`` with no host sync, for the captured serving tick.

    The pools carry one extra page at the end, the *sink*, which no page
    table names.  Every lane writes: a skipped lane, and a lane that a
    later lane overwrites at the same page id, writes the sink, where the
    reference routes it out of bounds for its scatter to drop.  Every
    other page ends as ``write_pages`` leaves it; the sink's contents are
    undefined.  -> (pool_k, pool_v)."""
    page = pool_k.shape[3]
    sink = pool_k.shape[2] - 1
    flat = slots.reshape(-1).to(pool_k.device).long()
    keep = _last_lanes(flat, (flat >= 0)
                       & valid.reshape(-1).to(pool_k.device))
    idx = torch.where(keep, flat, sink)
    for src, pool in ((kv[0], pool_k), (kv[1], pool_v)):
        pool[:, :, idx] = _page_blocks(src, page).to(pool.dtype)
    return pool_k, pool_v


def _decode_layers(cfg: ModelConfig, model: lm.LM, token, pos, pool_k,
                   pool_v, page_table, seq_with_new, lanes, cur_page,
                   cur_off):
    """The layers of one paged decode step: lanes ``lanes`` write their
    new K/V at (``cur_page``, ``cur_off``), then every lane attends
    through ``page_table`` over ``seq_with_new`` tokens (kernel 5) ->
    float32 logits [B, Vp]."""
    b = token.shape[0]
    x = _embed(cfg, model, token)[:, None, :]
    for li, block in enumerate(model.blocks):
        p = block.attn
        h = L.rms_norm(x, block.ln1, cfg.norm_eps)
        k_new, v_new = L.project_kv_step(
            p, h, pos, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta)
        pool_k[li][:, cur_page, cur_off] = k_new[lanes, 0].transpose(0, 1)
        pool_v[li][:, cur_page, cur_off] = v_new[lanes, 0].transpose(0, 1)
        q = (h @ p["wq"]).reshape(b, 1, cfg.num_heads, cfg.hd)
        q = L.rope(q, pos[:, None], cfg.rope_theta)[:, 0]
        o = kops.attend_paged(q.contiguous(), pool_k[li], pool_v[li],
                              page_table, seq_with_new,
                              softcap=cfg.attn_softcap)
        x = block.residual_mlp(
            cfg, x, o.reshape(b, 1, cfg.num_heads * cfg.hd) @ p["wo"])
    return _logits(cfg, model, x[:, 0])


@torch.no_grad()
def decode_paged(cfg: ModelConfig, model: lm.LM, token, pos, pool_k, pool_v,
                 page_table, active):
    """One paged decode step, in place on the pools.

    ``token``, ``pos`` int32 [B] (pos == tokens so far); pools [L, KVH, P,
    page, D]; ``page_table`` int32 [B, PPS]; ``active`` bool [B].  Inactive
    lanes write nothing and attend over nothing.
    -> (logits float32 [B, Vp], pool_k, pool_v)."""
    dev = pool_k.device
    token, pos = token.to(dev), pos.to(dev)
    page_table, active = page_table.to(dev, torch.int32), active.to(dev)
    page = pool_k.shape[3]
    seq_with_new = torch.where(active, pos + 1,
                               torch.zeros_like(pos)).to(torch.int32)
    lanes = torch.nonzero(active).flatten()
    cur_page = page_table[lanes, (pos[lanes] // page).long()].long()
    cur_off = (pos[lanes] % page).long()
    # each active lane writes its own private page: index_put_ with a
    # repeated index would be undefined on CUDA
    if torch.unique(cur_page).numel() != cur_page.numel():
        raise AssertionError("decode_paged: two lanes write one page")
    logits = _decode_layers(cfg, model, token, pos, pool_k, pool_v,
                            page_table, seq_with_new, lanes, cur_page,
                            cur_off)
    return logits, pool_k, pool_v


@torch.no_grad()
def decode_paged_sink(cfg: ModelConfig, model: lm.LM, token, pos, pool_k,
                      pool_v, page_table, active):
    """``decode_paged`` with no host sync, for the captured serving tick.

    Same arguments on one device, the pools with the sink page at the end
    (see ``write_pages_sink``).  Inactive lanes write the sink (the
    reference routes them out of bounds) and attend over nothing; the
    check that no two active lanes write one page becomes a flag.
    -> (logits float32 [B, Vp], clash bool []: two active lanes named one
    page, where ``decode_paged`` raises)."""
    b = token.shape[0]
    page = pool_k.shape[3]
    sink = pool_k.shape[2] - 1
    lanes = torch.arange(b, device=token.device)
    seq_with_new = torch.where(active, pos + 1,
                               torch.zeros_like(pos)).to(torch.int32)
    cur_page = torch.where(active, page_table[lanes, (pos // page).long()]
                           .long(), sink)
    cur_off = (pos % page).long()
    clash = (active[:, None] & active[None, :]
             & (cur_page[:, None] == cur_page[None, :])
             & (lanes[:, None] != lanes[None, :])).any()
    logits = _decode_layers(cfg, model, token, pos, pool_k, pool_v,
                            page_table, seq_with_new, lanes, cur_page,
                            cur_off)
    return logits, clash
