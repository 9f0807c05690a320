"""Model-layer primitives of the port: norms, RoPE, GQA attention (causal,
sliding-window, encoder, cross, decode), gated MLP, MoE and Mamba2 SSD.

Counterpart of ``repro/models/layers.py``.  Plain functions on tensors;
weights are ``[in, out]`` as in the reference (``x @ w``).  Dtypes mirror
the reference as XLA compiles it on the CPU: the compute dtype follows
``x`` (bf16 in the model), ``rms_norm`` and ``rope`` run in float32,
attention multiplies bf16 operands with float32 sums and a float32
softmax (the reference's ``preferred_element_type``; a product of two bf16
values is exact in float32), the MoE router and the SSD recurrence run in
float32.  None of these is a Pallas kernel in the reference; the paged
decode's attention is (kernel 5, ``kernels/paged_attention.py``).
"""
from __future__ import annotations

import dataclasses
import functools

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
    float32 weights [B,KVH,G,S,T].  The masked lanes take a scalar (no
    score-sized fill tensor) and the softcap's divide and tanh run in
    place on the scaled logits, so no more than two score-sized tensors
    are alive at once.  The product itself is scaled out of place: it is
    a view of the batched product's output, and an in-place op on it
    would make the backward copy the whole score tensor."""
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap > 0.0:
        logits = logits.div_(softcap).tanh_() * softcap
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    return torch.softmax(logits, dim=-1)


def _weighted_values(w, v):
    """bf16 weights (as the reference casts them) times v, summed in f32 ->
    [B, S, KVH, G, D] float32."""
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float())


def _attend(q, k, v, mask, scale, softcap):
    """``_weighted_values(_attn_weights(...), v)`` with the float32
    weights dropped once their bf16 copy is made: without a graph (which
    keeps the softmax for its backward) no more than two score-sized
    float32 tensors are alive at once (the product's operand and the copy
    the einsum lays out for its batched product)."""
    w = _attn_weights(q, k, mask, scale, softcap)
    wb = w.to(v.dtype)
    del w
    return torch.einsum("bkgst,btkd->bskgd", wb.float(), v.float())


# ---------------------------------------------------------------------------
# attention on head shards (a mesh whose model axis divides the heads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadShards:
    """One rank's share of an attention layer's heads on a mesh: ``hq``
    query heads (its slice of the model-sharded projection) and KV heads
    [kv0, kv0 + kvh), each group of ``hq // kvh`` query heads reading one
    KV head.  ``kv_sharded``: the
    K/V projections are split over the model axis as the queries are
    (``num_kv_heads`` divisible by it); else every rank computes all KV
    heads and slices the one its query heads read.  ``batch``: the
    placements of the layer input's batch sharding (data axes only)."""
    mesh: object
    axis: int
    batch: tuple
    hq: int
    kv0: int
    kvh: int
    kv_sharded: bool

    def placements(self, dim: int) -> list:
        """The batch sharding, and ``Shard(dim)`` over the model axis."""
        from torch.distributed.tensor import Shard

        return [Shard(dim) if m == self.axis else p
                for m, p in enumerate(self.batch)]

    def local(self, t, dim: int):
        """A DTensor -> this rank's rows and its slice of dimension
        ``dim`` (its heads), as a plain tensor."""
        return t.redistribute(self.mesh, self.placements(dim)).to_local()

    def rows(self, t, partial_grad: bool = False):
        """A batch-leading DTensor -> this rank's rows as a plain tensor; a
        plain tensor (positions or a mask of batch 1) as it is.
        ``partial_grad``: the rank reads only part of its rows' values, so
        the gradient it returns is a partial sum over the model axis."""
        from torch.distributed.tensor import DTensor, Partial

        if not isinstance(t, DTensor):
            return t
        grad = [Partial() if m == self.axis else p
                for m, p in enumerate(self.batch)]
        return t.redistribute(self.mesh, self.batch).to_local(
            grad_placements=grad if partial_grad else None)

    def kv_heads(self, t):
        """K or V [B, T, KVH, D] with every KV head on each rank (a
        batch-only DTensor or a cache) -> this rank's [b, T, kvh, D] (its
        gradient: a partial sum over the model axis)."""
        return self.rows(t, partial_grad=True)[:, :,
                                               self.kv0:self.kv0 + self.kvh]

    def gather(self, t):
        """This rank's [b, S, hq * D] -> the DTensor sharded on its last
        dimension over the model axis and on its batch as the input."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, self.placements(2),
                                  run_check=False)


def head_shards(x, wq, num_heads: int, num_kv_heads: int):
    """-> this rank's ``HeadShards`` where the attention core runs on head
    shards, else None (no mesh, or the batch-only path below).

    The rule follows the reference's partition, read from its compiled
    HLO: where the ``model`` axis (size m > 1) shards ``wq``'s output and
    divides ``num_heads``, the partitioner keeps q's model sharding
    through the reshape to heads, and each device holds H / m query
    heads and the KV heads they read: KVH / m where m divides KVH, else
    the one KV head of its partial group (H / m dividing the group size,
    e.g. mixtral's 48 / 8 heads on 16, internvl's 16 / 8).  A ``wq`` below
    the sharding threshold is replicated and the reference keeps every
    head on every device; so does the port.  Heads that m does not divide
    (gemma2-2b's 8, hymba-1.5b's 25, minicpm-2b's 36 on a 16-way axis)
    take the batch-only path: every model rank holds all heads of its
    rows (``_proj``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(x, DTensor) and isinstance(wq, DTensor)):
        return None
    from repro_torch.dist.sharding import data_axes

    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    axis = names.index("model")
    m = mesh.size(axis)
    if m == 1 or num_heads % m or wq.placements[axis] != Shard(1):
        return None
    hq, g = num_heads // m, num_heads // num_kv_heads
    if num_kv_heads % m and g % hq:
        return None
    q0 = mesh.get_local_rank(axis) * hq
    batch = tuple(p if p == Shard(0) and names[i] in data_axes(mesh)
                  else Replicate() for i, p in enumerate(x.placements))
    if num_kv_heads % m == 0:
        return HeadShards(mesh, axis, batch, hq, q0 // g, num_kv_heads // m,
                          True)
    return HeadShards(mesh, axis, batch, hq, q0 // g, 1, False)


def _attention_core(q, k, v, positions, mask, *, causal_self: bool,
                    scale: float, softcap: float, window: int,
                    q_chunk: int):
    """q [B,S,KVH,G,D], k / v [B,T,KVH,D] (plain tensors: one rank's
    heads on a mesh) -> float32 [B,S,KVH,G,D]; causal self-attention over
    S > 2 * q_chunk (a multiple of it) runs in q blocks."""
    s = q.shape[1]
    if causal_self and q_chunk and s > 2 * q_chunk and s % q_chunk == 0:
        outs = []
        for c in range(s // q_chunk):
            sl = slice(c * q_chunk, (c + 1) * q_chunk)
            m = causal_mask(positions[:, sl], positions, window=window)
            outs.append(_attend(q[:, sl], k, v, m, scale, softcap))
        return torch.cat(outs, dim=1)
    if mask is None:
        mask = causal_mask(positions, positions, window=window)
    return _attend(q, k, v, mask, scale, softcap)


def attention(p: dict, x, positions, mask=None, kv=None, *, num_heads: int,
              num_kv_heads: int, head_dim: int, rope_theta: float = 10000.0,
              softcap: float = 0.0, use_rope: bool = True, window: int = 0,
              q_chunk: int = ATTN_Q_CHUNK):
    """Full-sequence attention: causal self-attention (prefill, training),
    with an optional sliding ``window``; encoder attention under ``mask``;
    cross attention over precomputed ``kv``.

    ``x`` [B, S, d], ``positions`` [1 or B, S], ``mask`` bool [B or 1, S, T]
    (None: causal), ``kv`` (k, v) [B, T, KVH, D] (cross: no RoPE on q).
    For self-attention with S > 2 * q_chunk (and S a multiple of it) the
    query axis is blocked, as in the reference, so the logits are
    [B, H, q_chunk, S] at most; the blocked form is causal whatever
    ``mask`` says, as the reference's is.  On a mesh whose model axis
    divides the heads (``head_shards``) each rank runs the core on its
    own heads and rows, and the output projection reduces over the model
    axis.  -> (output [B, S, d], (k, v) [B, T, KVH, D]: the roped K and V
    the paged engine stores, or ``kv``).
    """
    b, s, _ = x.shape
    g = num_heads // num_kv_heads
    scale = head_dim ** -0.5
    core = functools.partial(_attention_core, causal_self=kv is None,
                             scale=scale, softcap=softcap, window=window,
                             q_chunk=q_chunk)
    hs = head_shards(x, p["wq"], num_heads, num_kv_heads)
    if hs is not None:
        return _attention_on_heads(hs, p, x, positions, mask, kv, core,
                                   head_dim=head_dim, rope_theta=rope_theta,
                                   use_rope=use_rope)
    q = _proj(x, p["wq"]).reshape(b, s, num_heads, head_dim)
    if kv is None:
        k = _proj(x, p["wk"]).reshape(b, s, num_kv_heads, head_dim)
        v = _proj(x, p["wv"]).reshape(b, s, num_kv_heads, head_dim)
        if use_rope:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
    else:
        k, v = kv
    o = core(q.reshape(b, s, num_kv_heads, g, head_dim), k, v, positions,
             mask)
    # batch-only before the output projection as well: on a 16-way model
    # axis DTensor's strategy for the merged product fails without it
    o = batch_only(o.reshape(b, s, num_heads * head_dim).to(x.dtype))
    return o @ p["wo"], (k, v)


def _attention_on_heads(hs: HeadShards, p, x, positions, mask, kv, core, *,
                        head_dim: int, rope_theta: float, use_rope: bool):
    """``attention`` on one rank's heads: q keeps the projection's model
    sharding (its local columns are the rank's heads), K / V are the
    rank's KV heads, the core runs on plain local tensors (DTensor never
    sees the merged batch x head dimension of its products), and the
    output re-enters DTensor sharded on its heads for ``wo``."""
    from torch.distributed.tensor import DTensor

    q = hs.local(x @ p["wq"], 2)
    b, s = q.shape[:2]
    q = q.reshape(b, s, hs.hq, head_dim)
    pos = hs.rows(positions)
    if kv is None:
        if hs.kv_sharded:
            k, v = (hs.local(x @ p[w], 2).reshape(b, s, hs.kvh, head_dim)
                    for w in ("wk", "wv"))
            if use_rope:
                k = rope(k, pos, rope_theta)
            kv = tuple(DTensor.from_local(t, hs.mesh, hs.placements(2),
                                          run_check=False) for t in (k, v))
        else:
            k, v = (_proj(x, p[w]).reshape(*x.shape[:2], -1, head_dim)
                    for w in ("wk", "wv"))
            if use_rope:
                k = rope(k, positions, rope_theta)
            kv = (k, v)
            k, v = hs.kv_heads(k), hs.kv_heads(v)
        if use_rope:
            q = rope(q, pos, rope_theta)
    else:
        k, v = hs.kv_heads(kv[0]), hs.kv_heads(kv[1])
    mask = None if mask is None else hs.rows(mask)
    o = core(q.reshape(b, s, hs.kvh, hs.hq // hs.kvh, head_dim), k, v, pos,
             mask)
    o = hs.gather(o.reshape(b, s, hs.hq * head_dim).to(x.dtype))
    return o @ p["wo"], kv


def cross_kv(p: dict, enc_out, *, num_kv_heads: int, head_dim: int):
    """Cross-attention K/V [B, T, KVH, D] of the encoder output (no RoPE)."""
    b, t, _ = enc_out.shape
    k = _proj(enc_out, p["wk"]).reshape(b, t, num_kv_heads, head_dim)
    v = _proj(enc_out, p["wv"]).reshape(b, t, num_kv_heads, head_dim)
    return k, v


def _decode_core(q, pos, k_cache, v_cache, *, scale: float, softcap: float,
                 window: int, is_cross: bool, cross_len, kv_new):
    """``decode_attention``'s softmax over the cache (plain tensors: one
    rank's heads and rows on a mesh): q [B, 1, KVH, G, D] roped, caches
    [B, T, KVH, D] -> float32 [B, 1, KVH, G, D]."""
    t = k_cache.shape[1]
    kpos = torch.arange(t, device=q.device)[None, :]
    if is_cross:
        mask = (kpos < cross_len[:, None])[:, None, :]
    else:
        diff = pos.long()[:, None, None] - kpos[:, None, :]      # [B, 1, T]
        mask = diff >= 1                                 # strictly older
        if window > 0:
            mask = mask & (diff < window)
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k_cache.float()) * scale
    if softcap > 0.0:
        logits = logits.div_(softcap).tanh_() * softcap
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    if kv_new is None:
        return _weighted_values(torch.softmax(logits, dim=-1), v_cache)
    k_new, v_new = kv_new
    l_self = torch.einsum("bskgd,bskd->bkgs", q.float(),
                          k_new.float())[..., None] * scale
    if softcap > 0.0:
        l_self = torch.tanh(l_self / softcap) * softcap
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), l_self)
    w_c = torch.exp(logits - m)
    w_s = torch.exp(l_self - m)                           # [B,KVH,G,1,1]
    num = _weighted_values(w_c, v_cache)
    num = num + w_s.permute(0, 3, 1, 2, 4) * v_new.float()[:, :, :, None]
    den = w_c.sum(dim=-1, keepdim=True) + w_s
    return num / den.permute(0, 3, 1, 2, 4)


def decode_attention(p: dict, x, pos, k_cache, v_cache, *, num_heads: int,
                     num_kv_heads: int, head_dim: int,
                     rope_theta: float = 10000.0, softcap: float = 0.0,
                     window: int = 0, is_cross: bool = False, cross_len=None,
                     kv_new=None):
    """One decode token against a K/V cache: attend, then append.

    ``x`` [B, 1, d], ``pos`` int [B] (the token's position); the caches
    [B, T, KVH, D] hold positions < pos and are only read here.  The
    current token's (k, v) [B, 1, KVH, D] arrive as ``kv_new`` and enter
    the softmax as one more lane (a two-part softmax), as in the
    reference, whose caller appends them once outside its layer loop.
    Cross attention (``is_cross``) reads the first ``cross_len`` [B]
    entries and ropes nothing.  On a mesh whose model axis divides the
    heads (``head_shards``) each rank reads its own KV heads of the
    caches (replicated over the model axis: a local slice) for its query
    heads.  -> [B, 1, d]."""
    b = x.shape[0]
    g = num_heads // num_kv_heads
    core = functools.partial(_decode_core, scale=head_dim ** -0.5,
                             softcap=softcap, window=window,
                             is_cross=is_cross)
    hs = head_shards(x, p["wq"], num_heads, num_kv_heads)
    if hs is not None:
        q = hs.local(x @ p["wq"], 2)
        bl = q.shape[0]
        q = q.reshape(bl, 1, hs.hq, head_dim)
        pos = hs.rows(pos)
        if not is_cross:
            q = rope(q, pos[:, None], rope_theta)
        o = core(q.reshape(bl, 1, hs.kvh, hs.hq // hs.kvh, head_dim), pos,
                 hs.kv_heads(k_cache), hs.kv_heads(v_cache),
                 cross_len=None if cross_len is None else hs.rows(cross_len),
                 kv_new=None if kv_new is None else tuple(
                     hs.kv_heads(t) for t in kv_new))
        o = hs.gather(o.reshape(bl, 1, hs.hq * head_dim).to(x.dtype))
        return o @ p["wo"]
    q = _proj(x, p["wq"]).reshape(b, 1, num_heads, head_dim)
    if not is_cross:
        q = rope(q, pos[:, None], rope_theta)
    o = core(q.reshape(b, 1, num_kv_heads, g, head_dim), pos, k_cache,
             v_cache, cross_len=cross_len, kv_new=kv_new)
    o = o.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return o @ p["wo"]


def project_kv_step(p: dict, x, pos, *, num_kv_heads: int, head_dim: int,
                    rope_theta: float = 10000.0):
    """K/V [B, 1, KVH, D] of the current decode token (K roped at ``pos``)."""
    b = x.shape[0]
    k = _proj(x, p["wk"]).reshape(b, 1, num_kv_heads, head_dim)
    v = _proj(x, p["wv"]).reshape(b, 1, num_kv_heads, head_dim)
    return rope(k, pos[:, None], rope_theta), v


def silu(x):
    """x * 1 / (1 + exp(-x)), one rounding to x's dtype per op, as the
    reference's ``jax.nn.silu`` runs in bf16 (a fused ``F.silu`` rounds
    once and differs in the last bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p: dict, x):
    """Gated MLP: (silu(x @ wg) * (x @ wi)) @ wo."""
    return (silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """``lax.top_k`` over the last axis, ties to the lower index: k rounds
    of argmax (k is at most a few), no sort and no host sync."""
    idx, vals = [], []
    rest = x
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        idx.append(i)
        vals.append(torch.gather(x, -1, i))
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def moe_route(p: dict, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, ff_shards: int = 1):
    """The reference's routing: a float32 router, softmax, top-k with the
    gates renormalised, each pick expanded to its ``ff_shards`` virtual
    experts (the same gate each), and a capacity of
    ``max(int(S * K * capacity_factor / E), K)`` pairs per virtual expert
    per batch row.  Pairs rank within their expert in (token, k) order
    (an exclusive cumsum); those at or past the capacity are dropped.

    -> (virtual expert [B, S, K'] int64, gate float32 [B, S, K'], rank
    [B, S, K'], keep bool [B, S, K'], capacity), K' = top_k * ff_shards."""
    b, s, _ = x.shape
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    vals, idx = _top_k(gates, top_k)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    if ff_shards > 1:
        fs = ff_shards
        idx = (idx[..., None] * fs + torch.arange(fs, device=x.device)
               ).reshape(b, s, top_k * fs)
        vals = vals.repeat_interleave(fs, dim=-1)
        top_k = top_k * fs
    e = num_experts * ff_shards
    cap = max(int(s * top_k * capacity_factor / e), top_k)
    onehot = (idx[..., None] == torch.arange(e, device=x.device)
              ).to(torch.int32).reshape(b, s * top_k, e)
    rank = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    rank = rank.reshape(b, s, top_k)
    return idx, vals, rank, rank < cap, cap


def moe(p: dict, x, *, num_experts: int, top_k: int,
        capacity_factor: float = 1.25, ff_shards: int = 1):
    """Top-k MoE with capacity-bounded dispatch, each batch row its own
    group (GShard), as the reference's ``moe``.  On a mesh (a batch-sharded
    DTensor ``x``) the dispatch and the combine run on each rank's own
    rows (a row's pairs never leave its group) and only the expert
    products run as DTensor ops on the weights' placements.

    ``x`` [B, S, d]; expert weights in the virtual-expert layout ``wi``,
    ``wg`` [E * ff_shards, d, d_ff / ff_shards], ``wo`` [E * ff_shards,
    d_ff / ff_shards, d]; ``router`` float32 [d, E].  Each kept (token, k)
    pair is copied into its expert's capacity buffer (one [E', B * cap, d]
    tensor, expert-major), every expert runs its gated MLP over its whole
    buffer (three batched products, dense as in the reference), and each
    pair reads its row back, weighted by its gate.  A dropped pair writes a
    sink row past the buffers and reads a weight of zero, so the dispatch
    has fixed shapes and no host sync (a CUDA graph captures it).
    -> [B, S, d] in x's dtype."""
    xd = batch_only(x)
    idx, vals, rank, keep, cap = (_local(t) for t in moe_route(
        p, xd, num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor, ff_shards=ff_shards))
    x = _local(xd)
    b, s, d = x.shape
    k = idx.shape[-1]
    e = num_experts * ff_shards
    rows = torch.arange(b, device=x.device)[:, None, None]
    base = (idx * b + rows) * cap            # slot 0 of the pair's buffer
    sink = e * b * cap
    buf = x.new_zeros(sink + 1, d)
    buf[torch.where(keep, base + rank, sink).reshape(-1)] = \
        x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
    hb = _like(buf[:sink].view(e, b * cap, d), xd, 1)
    h = silu(torch.bmm(hb, p["wg"])) * torch.bmm(hb, p["wi"])
    out = _local(batch_only(torch.bmm(h, p["wo"]), 1)).reshape(sink, d)
    # a dropped pair reads slot 0 of its buffer under a zero weight, as in
    # the reference
    got = out[torch.where(keep, base + rank, base).reshape(-1)]
    # the gate rounds to x's dtype; its product with the row and the sum
    # over k stay float32 until the one rounding at the end (XLA fuses the
    # reference's bf16 product into its float32 reduction)
    w = (vals.to(x.dtype) * keep.to(x.dtype)).float()
    return _like((got.reshape(b, s, k, d).float() * w[..., None]).sum(dim=2)
                 .to(x.dtype), xd, 0)


def moe_aux_loss(p: dict, x, *, num_experts: int, top_k: int):
    """Load-balancing auxiliary loss (Switch / Mixtral form), the
    reference's ``moe_aux_loss``: ``num_experts`` x the sum over experts
    of the share of top-k picks each gets times its mean gate, all float32
    (``x`` [B, S, d], ``router`` [d, E]).  As in the reference, no loss
    calls it (``TrainConfig.moe_aux_weight`` is unused)."""
    t = x.shape[0] * x.shape[1]
    gates = torch.softmax(x.reshape(t, -1).float() @ p["router"].float(),
                          dim=-1)
    _, idx = _top_k(gates, top_k)
    frac_tokens = torch.nn.functional.one_hot(idx, num_experts).float() \
        .mean(dim=(0, 1))
    return num_experts * torch.sum(frac_tokens * gates.mean(dim=0))


# ---------------------------------------------------------------------------
# Mamba2 (SSD, arXiv:2405.21060)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int
    nheads: int
    head_dim: int
    state: int    # N
    conv: int

    @staticmethod
    def from_config(d_model, state, expand=2, head_dim=64, conv=4):
        d_inner = expand * d_model
        return SSMDims(d_model, d_inner, d_inner // head_dim, head_dim,
                       state, conv)


def _split_zxbcdt(p, u, dims: SSMDims):
    zxbcdt = _proj(u, p["in_proj"])
    di, n = dims.d_inner, dims.state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv over the sequence, then silu.  ``xbc`` [B, S,
    C], ``conv_w`` [k, C], ``conv_state`` [B, k-1, C] (None: zeros) ->
    (out [B, S, C] in xbc's dtype, the last k-1 inputs as the new state)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1) + tuple(xbc.shape[2:]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    terms = [xp[:, i:i + s] * conv_w[i] for i in range(k)]
    # each product and partial sum rounds to xbc's dtype, but the last
    # sum, which the float32 silu reads, does not: XLA drops a rounding
    # that is cast straight back to float32
    out = terms[0]
    for t in terms[1:-1]:
        out = out + t
    out = out.float() + terms[-1].float() if k > 1 else \
        xp.float() * conv_w[0].float()
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return silu(out).to(xbc.dtype), new_state


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _like(t, like, batch_dim: int):
    """A local tensor -> a DTensor sharded on ``batch_dim`` as ``like``
    (batch-sharded on dim 0) is, replicated otherwise; ``t`` itself when
    ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(
        t, like.device_mesh,
        [Shard(batch_dim) if p == Shard(0) else Replicate()
         for p in like.placements], run_check=False)


def batch_only(x, batch_dim: int = 0):
    """A DTensor -> the same values sharded on its batch dimension over the
    data axes alone, replicated over every other mesh axis (an all-reduce
    or all-gather, as an SPMD partitioner inserts one); a plain tensor as
    it is.  The
    attention and SSD einsums merge the batch with the head dimensions,
    and DTensor has no strategy for a merged dimension that two mesh axes
    shard (its ``_StridedShard`` fails in ``bmm``), so these cores run
    batch-sharded between their projections (the gradients too: a
    redistribution's backward restores its input's placements)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.sharding import data_axes

    names, axes = x.device_mesh.mesh_dim_names, data_axes(x.device_mesh)
    return x.redistribute(x.device_mesh, [
        p if p == Shard(batch_dim) and names[m] in axes
        else Replicate() for m, p in enumerate(x.placements)])


def _proj(x, w):
    """``x @ w`` brought to batch-only sharding before its last dimension
    is split into heads (a model-sharded dimension of fewer heads than the
    axis cannot be unflattened)."""
    return batch_only(x @ w)


def ssd_scan(p: dict, u, dims: SSMDims, chunk: int = 128, init_state=None):
    """Chunked SSD forward (training / prefill) of the Mamba2 block:
    in_proj -> causal conv -> selective state update, quadratic within a
    chunk and recurrent across chunks -> gated RMSNorm -> out_proj.

    ``u`` [B, S, d_model] with S a multiple of ``min(chunk, S)``;
    ``init_state`` (ssm [B, nh, hp, N], conv [B, k-1, C]) or None.
    -> (y [B, S, d_model], (ssm state float32, conv state))."""
    b, s, _ = u.shape
    di, n, nh, hp = dims.d_inner, dims.state, dims.nheads, dims.head_dim
    f32 = torch.float32
    z, xbc, dt = _split_zxbcdt(p, u, dims)
    xbc, conv_state = _causal_conv(
        xbc, p["conv_w"], None if init_state is None else init_state[1])
    x, B_, C_ = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = _softplus(dt.float() + p["dt_bias"])                    # [B,S,nh]
    a = -torch.exp(p["A_log"].float())
    dA = dt * a
    xh = x.reshape(b, s, nh, hp).float()
    xdt = xh * dt[..., None]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    dA_c = dA.reshape(b, nc, chunk, nh)
    x_c = xdt.reshape(b, nc, chunk, nh, hp)
    B_c = B_.float().reshape(b, nc, chunk, n)
    C_c = C_.float().reshape(b, nc, chunk, n)

    lt = torch.cumsum(dA_c, dim=2)                               # [B,nc,Q,nh]
    diff = lt[:, :, :, None, :] - lt[:, :, None, :, :]        # [B,nc,Q,Q,nh]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=u.device))[None, None, :, :, None]
    # masked before exp: the upper triangle's large positive diffs would
    # overflow
    M = torch.exp(torch.where(tri, diff, torch.full_like(diff, NEG_INF)))
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * M, x_c)

    decay_end = torch.exp(lt[:, :, -1:, :] - lt)                 # [B,nc,Q,nh]
    chunk_states = torch.einsum("bcqhp,bcqn->bchpn",
                                decay_end[..., None] * x_c, B_c)
    chunk_decay = torch.exp(lt[:, :, -1, :])                     # [B,nc,nh]
    state = (torch.zeros(b, nh, hp, n, dtype=f32, device=u.device)
             if init_state is None else init_state[0].float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [B,nc,nh,hp,N]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C_c, prev_states) \
        * torch.exp(lt)[..., None]

    y = (y_intra + y_inter).reshape(b, s, nh, hp)
    y = (y + p["D"].float()[None, None, :, None] * xh).reshape(b, s, di)
    y = rms_norm(y * silu(z.float()), p["norm"])
    return batch_only(y.to(u.dtype)) @ p["out_proj"], (state, conv_state)


def ssd_step(p: dict, u, state, dims: SSMDims):
    """Single-token decode of the Mamba2 block: the recurrent state update.
    ``u`` [B, 1, d_model], ``state`` (ssm [B, nh, hp, N], conv [B, k-1, C])
    -> (y [B, 1, d_model], (ssm state in its dtype, conv state))."""
    b = u.shape[0]
    di, n, nh, hp = dims.d_inner, dims.state, dims.nheads, dims.head_dim
    ssm_state, conv_state = state
    z, xbc, dt = _split_zxbcdt(p, u, dims)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], conv_state)
    xbc = xbc[:, 0]
    x, B_, C_ = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])              # [B,nh]
    a = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * a)
    xh = x.reshape(b, nh, hp).float()
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], B_.float())
    new_state = ssm_state.float() * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_.float()) \
        + p["D"].float()[None, :, None] * xh
    y = rms_norm(y.reshape(b, 1, di) * silu(z.float()), p["norm"])
    return (y.to(u.dtype) @ p["out_proj"],
            (new_state.to(ssm_state.dtype), conv_state))
