"""The decoder-only LM of the port: parameters as ``nn.Module``s.

Counterpart of ``repro/models/lm.py`` for the dense configs (no experts,
no SSM, no encoder): one ``Block`` module per layer and the ``LM`` module
around them.  The reference stacks each layer's parameters on a leading L
axis; ``params_from_numpy`` / ``params_to_numpy`` convert between that
tree (as numpy arrays) and the modules, so a test can run both packages on
the same weights.  Weights are bf16, norm scales float32 (zeros: the norms
scale by ``1 + w``).  The full-sequence forward the serving path needs is
``serve/paged_model.py``; ``forward`` / ``decode_step`` / ``init_cache``
are still to port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import layers as L

VOCAB_ALIGN = 256

#: The reference layer families the port does not carry yet.
MOE_TODO = ("MoE layers are not ported yet (ROADMAP Queue A item 12: "
            "models/layers.py moe)")
SSM_TODO = ("SSM (Mamba2 SSD) layers are not ported yet (ROADMAP Queue A "
            "item 12: models/layers.py ssd_scan)")
ENCDEC_TODO = ("encoder-decoder models are not ported yet (ROADMAP Queue "
               "A item 12)")


def padded_vocab(cfg: ModelConfig) -> int:
    return (cfg.vocab_size + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full).  gemma2: even layers local."""
    if cfg.alt_local_global:
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    return [cfg.sliding_window] * cfg.num_layers


def check_dense(cfg: ModelConfig) -> None:
    """Raise ValueError for a config whose layers the port does not have."""
    if cfg.is_moe:
        raise ValueError(f"{cfg.name}: {MOE_TODO}")
    if cfg.has_ssm:
        raise ValueError(f"{cfg.name}: {SSM_TODO}")
    if cfg.enc_layers > 0:
        raise ValueError(f"{cfg.name}: {ENCDEC_TODO}")
    if not cfg.has_attention:
        raise ValueError(f"{cfg.name}: an attention-free config")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer: RMSNorm -> GQA attention -> RMSNorm -> gated MLP,
    each with a residual add."""

    def __init__(self, tensors: dict):
        super().__init__()
        self.ln1 = _param(tensors["ln1"])
        self.ln2 = _param(tensors["ln2"])
        self.attn = nn.ParameterDict(
            {k: _param(v) for k, v in tensors["attn"].items()})
        self.mlp = nn.ParameterDict(
            {k: _param(v) for k, v in tensors["mlp"].items()})

    def prefill(self, cfg: ModelConfig, x, positions, window: int):
        """Full-sequence block -> (x', (k, v) [B, S, KVH, D])."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = L.attention(
            self.attn, h, positions, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, softcap=cfg.attn_softcap,
            window=window)
        return self.residual_mlp(cfg, x, a), kv

    def residual_mlp(self, cfg: ModelConfig, x, a):
        """x + a, then + mlp(rms_norm(x + a)).  The norm reads the float32
        sum x + a before its bf16 rounding, and the residual the rounded
        sum: the numerics of the reference as XLA compiles it (it keeps
        the sum in float32 for the norm that consumes it)."""
        xm = x.float() + a.float()
        h2 = L.rms_norm(xm, self.ln2, cfg.norm_eps, dtype=x.dtype)
        return xm.to(x.dtype) + L.mlp(self.mlp, h2)


class LM(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and head (tied to the
    embedding when ``cfg.tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.blocks = nn.ModuleList(Block(b) for b in tensors["blocks"])
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(tensors["lm_head"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        """[d, Vp] output projection."""
        return self.embed.T if self.lm_head is None else self.lm_head


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights for a dense config, drawn on ``device`` (None: the
    card) from a ``torch.Generator`` seeded with ``seed``.  The draws differ
    from the reference's ``jax.random`` ones; ``params_from_numpy`` carries
    the reference's weights instead."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    vp = padded_vocab(cfg)

    def w(*shape, in_axis=0):
        return L.dense_init(gen, shape, in_axis=in_axis, device=dev)

    def zeros():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    blocks = [{
        "ln1": zeros(), "ln2": zeros(),
        "attn": {"wq": w(d, cfg.num_heads * hd),
                 "wk": w(d, cfg.num_kv_heads * hd),
                 "wv": w(d, cfg.num_kv_heads * hd),
                 "wo": w(cfg.num_heads * hd, d)},
        "mlp": {"wi": w(d, f), "wg": w(d, f), "wo": w(f, d)},
    } for _ in range(cfg.num_layers)]
    tensors = {"embed": w(vp, d, in_axis=1), "blocks": blocks,
               "final_norm": zeros()}
    if not cfg.tie_embeddings:
        tensors["lm_head"] = w(d, vp)
    return LM(cfg, tensors)


def _tensor(a, dtype, device) -> torch.Tensor:
    """numpy array (float32, or bfloat16 from ml_dtypes) -> tensor."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The reference's parameter tree (numpy leaves, per-layer leaves
    stacked on a leading L axis) -> ``LM`` on ``device`` (None: the card).
    Weights become bf16 and norm scales float32, as in the reference."""
    dev = resolve_device(device)
    bf, f32 = torch.bfloat16, torch.float32
    blk = tree["blocks"]
    blocks = [{
        "ln1": _tensor(blk["ln1"][i], f32, dev),
        "ln2": _tensor(blk["ln2"][i], f32, dev),
        "attn": {k: _tensor(v[i], bf, dev) for k, v in blk["attn"].items()},
        "mlp": {k: _tensor(v[i], bf, dev) for k, v in blk["mlp"].items()},
    } for i in range(cfg.num_layers)]
    tensors = {"embed": _tensor(tree["embed"], bf, dev), "blocks": blocks,
               "final_norm": _tensor(tree["final_norm"], f32, dev)}
    if not cfg.tie_embeddings:
        tensors["lm_head"] = _tensor(tree["lm_head"], bf, dev)
    return LM(cfg, tensors)


def params_to_numpy(model: LM) -> dict:
    """``LM`` -> the reference's tree layout as float32 numpy arrays (bf16
    weights widen exactly), per-layer leaves stacked on a leading L axis."""
    def a(t):
        return t.detach().float().cpu().numpy()

    def stack(get):
        return np.stack([a(get(b)) for b in model.blocks])

    b0 = model.blocks[0]
    tree = {
        "embed": a(model.embed),
        "blocks": {
            "ln1": stack(lambda b: b.ln1), "ln2": stack(lambda b: b.ln2),
            "attn": {k: stack(lambda b, k=k: b.attn[k]) for k in b0.attn},
            "mlp": {k: stack(lambda b, k=k: b.mlp[k]) for k in b0.mlp},
        },
        "final_norm": a(model.final_norm),
    }
    if model.lm_head is not None:
        tree["lm_head"] = a(model.lm_head)
    return tree
