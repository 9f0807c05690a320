"""The LM of the port, every family of the reference: parameters as
``nn.Module``s, the full-sequence forward and the single-token decode.

Counterpart of ``repro/models/lm.py``: a decoder-only transformer (dense,
MoE, sliding-window, local/global with softcaps), pure SSM (mamba2),
hybrid parallel attention + SSM heads (hymba, mean-fused), an
encoder-decoder (the seamless backbone, encoder over stub frame
embeddings) and a prefix-embedding VLM (the internvl backbone).  One
``Block`` module per layer holds the parts its config has (``attn``,
``ssm``, ``cross`` + ``ln_cross``, ``moe`` or ``mlp``); the encoder's
blocks are ``Block``s too.  The reference stacks each layer's parameters
on a leading L axis; ``params_from_numpy`` / ``params_to_numpy`` convert
between that tree (as numpy arrays) and the modules, so a test can run
both packages on the same weights (``grads_to_numpy`` does it for the
gradients, ``to_tree`` / ``from_tree`` for any per-parameter tensors).
Weights are bf16; the MoE router, the SSD's ``A_log`` / ``D`` /
``dt_bias`` / ``norm`` and the norm scales are float32 (the norms scale
by ``1 + w``).

On a mesh (DTensor weights, ``dist.sharding``) the residual stream stays
sharded on the batch alone: each sublayer's output is brought back to
that (``layers.batch_only``, the all-reduce or all-gather an SPMD
partitioner puts after a row- or column-sharded product).

Training rematerialises every block as the reference does
(``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``): where a
graph is being built, each decoder and encoder block runs under
``torch.utils.checkpoint`` with a selective policy (``remat_policy``) that
keeps the outputs of its products without a batch dimension and
recomputes everything else in the backward.  Serving builds no graph and
never enters it.

Numerics follow the reference as XLA compiles its layer loop: a bf16 op
whose result is cast straight to float32 keeps its float32 value (the
residual sum that a norm reads), every other bf16 op rounds.  The paged
serving path is ``serve/paged_model.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import SSMDims

VOCAB_ALIGN = 256

#: parts of a block whose leaves stay float32 (the rest are bf16)
F32_LEAVES = {"moe": ("router",), "ssm": ("A_log", "D", "dt_bias", "norm")}
#: a block's parts that hold weight dicts, in the order the port draws them
PARTS = ("attn", "ssm", "cross", "moe", "mlp")
#: a block's norm scales (float32 vectors)
NORMS = ("ln1", "ln2", "ln_cross")


def padded_vocab(cfg: ModelConfig) -> int:
    return (cfg.vocab_size + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


def ssm_dims(cfg: ModelConfig) -> SSMDims:
    return SSMDims.from_config(cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                               cfg.ssm_head_dim, cfg.ssm_conv)


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full).  gemma2: even layers local."""
    if cfg.alt_local_global:
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    return [cfg.sliding_window] * cfg.num_layers


def _param(t: torch.Tensor) -> nn.Parameter:
    """A frozen weight: serving builds no graph; the trainer unfreezes."""
    return nn.Parameter(t, requires_grad=False)


def _bf16_scale(cfg: ModelConfig) -> float:
    """``scale_emb`` rounded to bf16, as the reference multiplies (a Python
    float keeps the host free of a device copy)."""
    return float(torch.tensor(cfg.scale_emb, dtype=torch.bfloat16))


class Block(nn.Module):
    """One layer: RMSNorm -> the token mixer (GQA attention, SSD heads, or
    both averaged) -> [RMSNorm -> cross attention] -> RMSNorm -> gated MLP
    or MoE, each with a residual add.  A part the config lacks is None."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name in NORMS:
            t = tensors.get(name)
            setattr(self, name, None if t is None else _param(t))
        for name in PARTS:
            part = tensors.get(name)
            setattr(self, name, None if part is None else nn.ParameterDict(
                {k: _param(v) for k, v in part.items()}))

    def _attend(self, cfg, h, positions, window, mask=None):
        return L.attention(
            self.attn, h, positions, mask, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap,
            window=window)

    def ffn(self, cfg: ModelConfig, h):
        """The MoE or the gated MLP of this layer on normed ``h``."""
        if self.moe is not None:
            return L.moe(self.moe, h, num_experts=cfg.num_experts,
                         top_k=cfg.top_k, ff_shards=cfg.moe_ff_shards)
        return L.mlp(self.mlp, h)

    def residual_mlp(self, cfg: ModelConfig, x, a):
        """x + a, then + ffn(rms_norm(x + a)) (the paged decode's tail)."""
        return self._ffn_residual(cfg, x.float() + a.float(), x.dtype)

    def _cross_residual(self, cfg, xm, dtype, attend):
        """The cross-attention sublayer on the float32 sum ``xm`` ->
        the next float32 sum."""
        hc = L.rms_norm(xm, self.ln_cross, cfg.norm_eps, dtype=dtype)
        return xm.to(dtype).float() + L.batch_only(attend(hc)).float()

    def seq(self, cfg: ModelConfig, x, positions, window: int,
            enc_out=None, enc_mask=None):
        """The block over a full sequence (prefill, training) -> (x', the
        roped K and V [B, S, KVH, D] of its attention, or None)."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        mix, kv = None, None
        if self.attn is not None:
            mix, kv = self._attend(cfg, h, positions, window)
        if self.ssm is not None:
            y, _ = L.ssd_scan(self.ssm, h, ssm_dims(cfg))
            mix = y if mix is None else mix + y
        if self.attn is not None and self.ssm is not None:
            mix = mix * 0.5                # hymba: mean-fused parallel heads
        xm = x.float() + L.batch_only(mix).float()
        if self.cross is not None:
            kvc = L.cross_kv(self.cross, enc_out,
                             num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd)
            xm = self._cross_residual(cfg, xm, x.dtype, lambda hc: L.attention(
                self.cross, hc, positions, enc_mask, kv=kvc,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                use_rope=False)[0])
        return self._ffn_residual(cfg, xm, x.dtype), kv

    def _ffn_residual(self, cfg, xm, dtype):
        """The float32 residual sum ``xm`` -> x' in ``dtype``: + the ffn of
        its norm, if the layer has one.  The norm reads ``xm`` before its
        rounding, the residual the rounded sum: the reference as XLA
        compiles it keeps a sum that a norm consumes in float32."""
        if self.moe is None and self.mlp is None:
            return xm.to(dtype)
        h2 = L.rms_norm(xm, self.ln2, cfg.norm_eps, dtype=dtype)
        return xm.to(dtype) + L.batch_only(self.ffn(cfg, h2))

    def encode(self, cfg: ModelConfig, x, positions, mask):
        """An encoder block: bidirectional attention under ``mask``, then
        the gated MLP."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, _ = self._attend(cfg, h, positions, 0, mask)
        return self._ffn_residual(cfg, x.float() + L.batch_only(a).float(),
                                  x.dtype)

    def unread_weights(self) -> tuple:
        """The weights of the block's last projections, whose outputs only
        the residual add reads: the MLP's ``wo``; with no MLP or MoE, the
        cross attention's ``wo``, else the token mixers' output
        projections.  The backward never reads these products, so
        ``jax.checkpoint`` drops them from its residuals, and the remat
        policy does not save them either."""
        if self.mlp is not None:
            return (self.mlp["wo"],)
        if self.moe is not None:
            return ()                    # its last products are batched
        if self.cross is not None:
            return (self.cross["wo"],)
        return tuple(part[k] for part, k in ((self.attn, "wo"),
                                             (self.ssm, "out_proj"))
                     if part is not None)

    def decode(self, cfg: ModelConfig, x, pos, window: int, ck=None,
               cv=None, cssm=None, cconv=None, xk=None, xv=None, xlen=None):
        """The block for one token against read-only caches (attend, then
        the caller appends) -> (x', k_new, v_new, ssm state, conv state)."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        mix = k_new = v_new = None
        if self.attn is not None:
            k_new, v_new = L.project_kv_step(
                self.attn, h, pos, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd, rope_theta=cfg.rope_theta)
            mix = L.decode_attention(
                self.attn, h, pos, ck, cv, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap,
                window=window, kv_new=(k_new, v_new))
        if self.ssm is not None:
            y, (cssm, cconv) = L.ssd_step(self.ssm, h, (cssm, cconv),
                                          ssm_dims(cfg))
            mix = y if mix is None else mix + y
        if self.attn is not None and self.ssm is not None:
            mix = mix * 0.5
        xm = x.float() + L.batch_only(mix).float()
        if self.cross is not None:
            xm = self._cross_residual(
                cfg, xm, x.dtype, lambda hc: L.decode_attention(
                    self.cross, hc, pos, xk, xv, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta, is_cross=True,
                    cross_len=xlen))
        return self._ffn_residual(cfg, xm, x.dtype), k_new, v_new, cssm, \
            cconv


class LM(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and head (tied to the
    embedding when ``cfg.tie_embeddings``); an encoder-decoder config adds
    ``enc_layers`` encoder blocks and their final norm."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.blocks = nn.ModuleList(Block(b) for b in tensors["blocks"])
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(tensors["lm_head"]))
        self.enc_blocks = nn.ModuleList(
            Block(b) for b in tensors.get("enc_blocks", ()))
        self.enc_norm = (_param(tensors["enc_norm"])
                         if "enc_norm" in tensors else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        """[d, Vp] output projection."""
        return self.embed.T if self.lm_head is None else self.lm_head


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig, cross: bool) -> dict:
    """{part: {leaf: (shape, in_axis)}} of one block, in draw order."""
    d, hd = cfg.d_model, cfg.hd
    attn = {"wq": ((d, cfg.num_heads * hd), 0),
            "wk": ((d, cfg.num_kv_heads * hd), 0),
            "wv": ((d, cfg.num_kv_heads * hd), 0),
            "wo": ((cfg.num_heads * hd, d), 0)}
    parts = {}
    if cfg.has_attention:
        parts["attn"] = attn
    if cfg.has_ssm:
        dims = ssm_dims(cfg)
        zxbcdt = 2 * dims.d_inner + 2 * dims.state + dims.nheads
        parts["ssm"] = {
            "in_proj": ((d, zxbcdt), 0),
            "conv_w": ((dims.conv, dims.d_inner + 2 * dims.state), 0),
            "out_proj": ((dims.d_inner, d), 0)}
    if cross:
        parts["cross"] = dict(attn)
    if cfg.is_moe:
        ev, ffv = cfg.num_virtual_experts, cfg.virtual_d_ff
        parts["moe"] = {"router": ((d, cfg.num_experts), 0),
                        "wi": ((ev, d, ffv), 1), "wg": ((ev, d, ffv), 1),
                        "wo": ((ev, ffv, d), 1)}
    elif cfg.d_ff > 0:
        parts["mlp"] = {"wi": ((d, cfg.d_ff), 0), "wg": ((d, cfg.d_ff), 0),
                        "wo": ((cfg.d_ff, d), 0)}
    return parts


def _dtype(part: str, leaf: str):
    return (torch.float32 if leaf in F32_LEAVES.get(part, ())
            else torch.bfloat16)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                empty: bool = False) -> LM:
    """Random weights for any config, drawn on ``device`` (None: the card)
    from a ``torch.Generator`` seeded with ``seed``: dense weights normal x
    fan_in^-0.5, norms and ``dt_bias`` / ``A_log`` zeros, ``D`` ones, as
    the reference initialises them.  The draws differ from the reference's
    ``jax.random`` ones; ``params_from_numpy`` carries the reference's
    weights instead.  ``empty=True`` draws nothing: every dense weight is
    ``torch.empty`` of its shape and dtype, so on ``device="meta"`` or
    under ``FakeTensorMode`` the model allocates nothing (the dry run's
    ``configs.param_specs``)."""
    dev = resolve_device(device)
    gen = None if empty else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def dense(shape, in_axis=0, dtype=torch.bfloat16):
        if empty:
            return torch.empty(shape, dtype=dtype, device=dev)
        return L.dense_init(gen, shape, in_axis=in_axis, dtype=dtype,
                            device=dev)

    def vec(fill=0.0, n=d):
        return torch.full((n,), fill, dtype=torch.float32, device=dev)

    def block(cross):
        t = {"ln1": vec(), "ln2": vec()}
        for part, leaves in _block_shapes(cfg, cross).items():
            t[part] = {leaf: dense(shape, ax, _dtype(part, leaf))
                       for leaf, (shape, ax) in leaves.items()}
        if cfg.has_ssm:
            nh = ssm_dims(cfg).nheads
            t["ssm"].update(A_log=vec(0.0, nh), D=vec(1.0, nh),
                            dt_bias=vec(0.0, nh),
                            norm=vec(0.0, ssm_dims(cfg).d_inner))
        if cross:
            t["ln_cross"] = vec()
        return t

    encdec = cfg.enc_layers > 0
    tensors = {"blocks": [block(encdec) for _ in range(cfg.num_layers)]}
    tensors["embed"] = dense((padded_vocab(cfg), d), in_axis=1)
    tensors["final_norm"] = vec()
    if not cfg.tie_embeddings:
        tensors["lm_head"] = dense((d, padded_vocab(cfg)))
    if encdec:
        tensors["enc_blocks"] = [block(False) for _ in range(cfg.enc_layers)]
        tensors["enc_norm"] = vec()
    return LM(cfg, tensors)


def _tensor(a, dtype, device) -> torch.Tensor:
    """numpy array (float32, or bfloat16 from ml_dtypes) -> tensor."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _blocks_from_numpy(stacked: dict, n: int, dev) -> list:
    out = []
    for i in range(n):
        t = {}
        for name, leaf in stacked.items():
            if isinstance(leaf, dict):
                t[name] = {k: _tensor(v[i], _dtype(name, k), dev)
                           for k, v in leaf.items()}
            else:
                t[name] = _tensor(leaf[i], torch.float32, dev)
        out.append(t)
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The reference's parameter tree (numpy leaves, per-layer leaves
    stacked on a leading L axis) -> ``LM`` on ``device`` (None: the card).
    The router and the SSD's float32 leaves and the norm scales stay
    float32, every other weight becomes bf16, as in the reference."""
    dev = resolve_device(device)
    bf, f32 = torch.bfloat16, torch.float32
    tensors = {"embed": _tensor(tree["embed"], bf, dev),
               "blocks": _blocks_from_numpy(tree["blocks"], cfg.num_layers,
                                            dev),
               "final_norm": _tensor(tree["final_norm"], f32, dev)}
    if not cfg.tie_embeddings:
        tensors["lm_head"] = _tensor(tree["lm_head"], bf, dev)
    if "enc_blocks" in tree:
        tensors["enc_blocks"] = _blocks_from_numpy(tree["enc_blocks"],
                                                   cfg.enc_layers, dev)
        tensors["enc_norm"] = _tensor(tree["enc_norm"], f32, dev)
    return LM(cfg, tensors)


def tree_paths(model: LM) -> list:
    """(parameter name, key path in the reference's tree, layer index or
    None) of every parameter, in ``named_parameters()`` order: a block's
    leaf ``blocks.3.attn.wq`` is row 3 of the reference's stacked
    ``["blocks"]["attn"]["wq"]``."""
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            out.append((name, (parts[0], *parts[2:]), int(parts[1])))
        else:
            out.append((name, (parts[0],), None))
    return out


def to_tree(model: LM, leaves: dict) -> dict:
    """{parameter name: numpy array} -> the reference's tree layout, the
    per-layer leaves stacked on a leading L axis."""
    tree, stacks = {}, {}
    for name, keys, i in tree_paths(model):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if i is None:
            node[keys[-1]] = leaves[name]
        else:
            stacks.setdefault(keys, (node, []))[1].append(leaves[name])
    for keys, (node, rows) in stacks.items():
        node[keys[-1]] = np.stack(rows)
    return tree


def from_tree(model: LM, tree: dict) -> dict:
    """The reference's stacked tree -> {parameter name: numpy array}."""
    out = {}
    for name, keys, i in tree_paths(model):
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        out[name] = np.asarray(leaf if i is None else leaf[i])
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(model: LM) -> dict:
    """``LM`` -> the reference's tree layout as float32 numpy arrays (bf16
    weights widen exactly), per-layer leaves stacked on a leading L axis."""
    return to_tree(model, {n: _np(p) for n, p in model.named_parameters()})


def grads_to_numpy(model: LM) -> dict:
    """The parameters' ``.grad`` in the reference's tree layout (float32
    numpy); a parameter without a gradient (mamba2's ``ln2``: its block has
    no MLP) gives zeros, as ``jax.grad`` does."""
    return to_tree(model, {
        n: np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, model: LM, tokens) -> torch.Tensor:
    """The tokens' embedding rows times the bf16 ``scale_emb``, looked up
    by ``F.embedding``: on a mesh, DTensor shards it by vocabulary (a
    masked partial sum, reduced here)."""
    rows = torch.nn.functional.embedding(tokens.long(), model.embed)
    return L.batch_only(rows * _bf16_scale(cfg))


def _head_logits(cfg: ModelConfig, model: LM, x) -> torch.Tensor:
    """Final norm, head and final softcap -> bf16 logits, as the
    reference's ``forward`` / ``decode_step`` return them."""
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = x @ model.head()
    if cfg.final_softcap > 0:
        lf = logits.float()
        logits = (torch.tanh(lf / cfg.final_softcap)
                  * cfg.final_softcap).to(logits.dtype)
    return logits


#: products without a batch dimension: the port writes each as ``x @ w``
#: of a 2-D weight (the projections, the router), which reaches ``mm`` /
#: ``addmm``; every batched product (the attention and SSD einsums, the
#: MoE's expert products) reaches ``bmm``, whatever its batch extent
NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy(unread):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` as a
    selective-checkpoint policy: save the result of a product with no
    batch dimension, recompute every other op.  A product whose weight is
    in ``unread`` (``Block.unread_weights``) is recomputed too: its output
    is read by no backward, so JAX keeps no residual of it either.  An op
    run under ``layers.remat_mark`` is saved or recomputed as the mark
    says (a product kept after its reduce, ``layers.SSDHeads.product``)."""
    def policy(ctx, op, *args, **kwargs):
        mark = L.REMAT_MARK[0]
        if mark is not None:
            return (CheckpointPolicy.MUST_SAVE if mark == "save"
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        if op in NO_BATCH_PRODUCTS and not any(
                a is w for a in args for w in unread):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _call_block(block: Block, fn, remat: bool, *args) -> torch.Tensor:
    """``fn(*args)``, under the remat policy where a graph is being built
    (grad enabled and a block parameter requires grad): the block's
    activations are recomputed in the backward but for its products'
    outputs.  Serving, prefill and the tick's capture build no graph and
    call ``fn`` directly.  The forward draws no random numbers, so no RNG
    state is kept (its probe of the inputs' device fails on a fake mesh)."""
    if not (remat and torch.is_grad_enabled()
            and any(p.requires_grad for p in block.parameters())):
        return fn(*args)
    policy = remat_policy(block.unread_weights())
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(
                          policy))


def _encode(cfg: ModelConfig, model: LM, enc_embeds,
            remat: bool = True) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings [B, T, d]; each
    block rematerialised where a graph is built, as the reference's
    always is."""
    t = enc_embeds.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=enc_embeds.device)[None]
    full = torch.ones((1, t, t), dtype=torch.bool, device=enc_embeds.device)
    x = enc_embeds
    for block in model.enc_blocks:
        x = _call_block(block, functools.partial(block.encode, cfg), remat,
                        x, pos, full)
    return L.rms_norm(x, model.enc_norm, cfg.norm_eps)


def _decode_blocks(cfg: ModelConfig, model: LM, x, positions, enc_out,
                   enc_mask, remat: bool = True) -> torch.Tensor:
    """The decoder blocks over the full sequence, as the reference's
    ``_scan_blocks(remat=True)``: the output alone (training drops the
    K / V that ``Block.seq`` returns for prefill)."""
    for block, window in zip(model.blocks, layer_windows(cfg)):
        def seq(x, positions, enc_out, enc_mask, block=block, window=window):
            return block.seq(cfg, x, positions, window, enc_out, enc_mask)[0]

        x = _call_block(block, seq, remat, x, positions, enc_out, enc_mask)
    return x


def forward(cfg: ModelConfig, model: LM, tokens, prefix_embeds=None,
            enc_embeds=None) -> torch.Tensor:
    """Logits [B, S, padded_vocab] (bf16) over the full sequence: the
    ``prefix_embeds`` [B, P, d] (the VLM stub) then the tokens [B, S_tok];
    an encoder-decoder config encodes ``enc_embeds`` [B, T_enc, d] (the
    audio stub) and cross-attends to it from every decoder block.  It
    builds an autograd graph only when the parameters require grad, as
    the trainer sets them (``model.requires_grad_(True)``), and then
    rematerialises every block; the weights are built frozen, so serving
    stays graph-free."""
    return _forward(cfg, model, tokens, prefix_embeds, enc_embeds)


def _forward(cfg: ModelConfig, model: LM, tokens, prefix_embeds=None,
             enc_embeds=None, remat: bool = True) -> torch.Tensor:
    """``forward``; ``remat=False`` keeps every block's activations for
    the backward (the dry run's comparison; the reference has no such
    switch on its forward)."""
    x = _embed(cfg, model, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    enc_out = enc_mask = None
    if cfg.enc_layers > 0:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "enc_embeds")
        enc_out = _encode(cfg, model, enc_embeds, remat)
        enc_mask = torch.ones((1, s, enc_out.shape[1]), dtype=torch.bool,
                              device=x.device)
    x = _decode_blocks(cfg, model, x, positions, enc_out, enc_mask, remat)
    return _head_logits(cfg, model, x)


# ---------------------------------------------------------------------------
# decode: one new token against the caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The decode state, on ``device`` (None: the card): K/V [L, B, T, KVH,
    D]; the SSD state [L, B, nh, hp, N] float32 and conv state [L, B, k-1,
    C]; cross K/V [L, B, max_seq // 2, KVH, D] with ``cross_len`` [B]."""
    dev = resolve_device(device)
    cache = {}
    if cfg.has_attention:
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.has_ssm:
        d = ssm_dims(cfg)
        cache["ssm"] = torch.zeros(
            (cfg.num_layers, batch, d.nheads, d.head_dim, d.state),
            dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (cfg.num_layers, batch, d.conv - 1, d.d_inner + 2 * d.state),
            dtype=dtype, device=dev)
    if cfg.enc_layers > 0:
        enc_t = max_seq // 2
        kv = (cfg.num_layers, batch, enc_t, cfg.num_kv_heads, cfg.hd)
        cache["cross_k"] = torch.zeros(kv, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(kv, dtype=dtype, device=dev)
        cache["cross_len"] = torch.full((batch,), enc_t, dtype=torch.int32,
                                        device=dev)
    return cache


def _append_kv(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Write each lane's new K or V [L, B, KVH, D] into the cache [L, B,
    T, KVH, D] at its position (a position past the cache writes nothing).
    A batch-sharded DTensor cache is written on each rank's own lanes, as
    an SPMD partitioner writes it: no collective, the cache keeps its
    placements (DTensor has no in-place strategy for this scatter)."""
    if isinstance(c, DTensor):
        pl = c.placements
        pos_pl = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
        _append_kv(c.to_local(),
                   new.redistribute(c.device_mesh, pl).to_local(),
                   pos.redistribute(c.device_mesh, pos_pl).to_local())
        return
    t = c.shape[2]
    lanes = torch.arange(c.shape[1], device=c.device)
    at_pos = pos.long().clamp(0, t - 1)
    inside = (pos.long() < t)[None, :, None, None]
    c[:, lanes, at_pos] = torch.where(inside, new.to(c.dtype),
                                      c[:, lanes, at_pos])


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, token, pos, cache: dict):
    """One serve step: ``token`` int [B] at positions ``pos`` int [B] (==
    the length so far) against ``cache`` -> (logits [B, padded_vocab]
    bf16, the cache).  The layers only read the K/V cache; the new
    tokens' K/V are appended after the layer loop (a position past the
    cache writes nothing), and the SSD states replaced.  The cache's
    tensors are updated in place and returned in a new dict."""
    x = _embed(cfg, model, token)[:, None]
    windows = layer_windows(cfg)
    news = []
    for li, block in enumerate(model.blocks):
        def at(name):
            return cache[name][li] if name in cache else None

        x, k_new, v_new, cssm, cconv = block.decode(
            cfg, x, pos, windows[li], at("k"), at("v"), at("ssm"),
            at("conv"), at("cross_k"), at("cross_v"), cache.get("cross_len"))
        news.append((k_new, v_new, cssm, cconv))
    logits = _head_logits(cfg, model, x)[:, 0]
    new_cache = dict(cache)
    if cfg.has_attention:
        for name, j in (("k", 0), ("v", 1)):
            new = torch.stack([n[j][:, 0] for n in news])    # [L, B, KVH, D]
            _append_kv(cache[name], new, pos)
    if cfg.has_ssm:
        for li, (_, _, cssm, cconv) in enumerate(news):
            cache["ssm"][li] = cssm
            cache["conv"][li] = cconv
    return logits, new_cache
