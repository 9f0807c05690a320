"""Model-layer primitives of the port: norms, RoPE, GQA attention, MLP.

Counterpart of ``repro/models/layers.py`` for the dense decoder layers the
serving path runs.  Plain functions on tensors; weights are ``[in, out]``
as in the reference (``x @ w``).  Dtypes mirror the reference: the compute
dtype follows ``x`` (bf16 in the model), ``rms_norm`` and ``rope`` run in
float32, and attention multiplies bf16 operands with float32 sums and a
float32 softmax (the reference's ``preferred_element_type``; a product of
two bf16 values is exact in float32).  MoE, the Mamba2 SSD scan and
``decode_attention`` are still to port.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38

#: q-block size for long causal sequences (see ``attention``).
ATTN_Q_CHUNK = 2048


def dense_init(generator: torch.Generator, shape, in_axis=0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """normal x fan_in^-0.5, drawn in float32 from ``generator`` and cast."""
    fan_in = shape[in_axis] if in_axis is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * fan_in ** -0.5).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             dtype=None):
    """RMSNorm in float32, scaled by ``1 + w``, cast to ``dtype`` (None:
    x's dtype)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dtype or x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding.  x: [..., S, H, D], positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(float(theta), exps)            # float32 powers
    angles = positions[..., :, None].float() * freqs        # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(positions_q, positions_k, window=0):
    """Causal (+ optional sliding window) mask [B, S, T] from absolute
    positions [B, S] and [B, T]; ``window`` 0 is full causal."""
    diff = positions_q[:, :, None] - positions_k[:, None, :]
    m = diff >= 0
    if window > 0:
        m = m & (diff < window)
    return m


def _attn_weights(q, k, mask, scale, softcap):
    """q [B,S,KVH,G,D], k [B,T,KVH,D], mask [B or 1, S, T] ->
    float32 weights [B,KVH,G,S,T]."""
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1)


def _weighted_values(w, v):
    """bf16 weights (as the reference casts them) times v, summed in f32 ->
    [B, S, KVH, G, D] float32."""
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float())


def attention(p: dict, x, positions, *, num_heads: int, num_kv_heads: int,
              head_dim: int, rope_theta: float = 10000.0,
              softcap: float = 0.0, window: int = 0,
              q_chunk: int = ATTN_Q_CHUNK):
    """Causal self-attention over a full sequence (prefill), with an
    optional sliding ``window``.

    ``x`` [B, S, d], ``positions`` [1 or B, S].  For S > 2 * q_chunk (and S
    a multiple of it) the query axis is blocked, as in the reference, so
    the logits are [B, H, q_chunk, S] at most.  -> (output [B, S, d], the
    roped K and V [B, S, KVH, D] that the paged engine stores).
    """
    b, s, _ = x.shape
    g = num_heads // num_kv_heads
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, num_kv_heads, head_dim)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    q = q.reshape(b, s, num_kv_heads, g, head_dim)
    scale = head_dim ** -0.5
    if q_chunk and s > 2 * q_chunk and s % q_chunk == 0:
        outs = []
        for c in range(s // q_chunk):
            sl = slice(c * q_chunk, (c + 1) * q_chunk)
            m = causal_mask(positions[:, sl], positions, window=window)
            w = _attn_weights(q[:, sl], k, m, scale, softcap)
            outs.append(_weighted_values(w, v))
        o = torch.cat(outs, dim=1)
    else:
        mask = causal_mask(positions, positions, window=window)
        o = _weighted_values(_attn_weights(q, k, mask, scale, softcap), v)
    o = o.reshape(b, s, num_heads * head_dim).to(x.dtype)
    return o @ p["wo"], (k, v)


def project_kv_step(p: dict, x, pos, *, num_kv_heads: int, head_dim: int,
                    rope_theta: float = 10000.0):
    """K/V [B, 1, KVH, D] of the current decode token (K roped at ``pos``)."""
    b = x.shape[0]
    k = (x @ p["wk"]).reshape(b, 1, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, 1, num_kv_heads, head_dim)
    return rope(k, pos[:, None], rope_theta), v


def silu(x):
    """x * 1 / (1 + exp(-x)), one rounding to x's dtype per op, as the
    reference's ``jax.nn.silu`` runs in bf16 (a fused ``F.silu`` rounds
    once and differs in the last bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p: dict, x):
    """Gated MLP: (silu(x @ wg) * (x @ wi)) @ wo."""
    return (silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
