"""Config schema: model architecture, input shapes, mesh, cache.

One ``ModelConfig`` describes any of the 10 assigned architectures (dense /
MoE / hybrid / SSM / VLM-backbone / audio enc-dec).  ``ShapeConfig`` is one
(seq_len, global_batch, kind) cell; ``ArchSpec`` binds a ModelConfig to its
shape set and smoke-test reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    # TPU adaptation (EXPERIMENTS.md §Perf iter 7): slice each expert's ff
    # into `moe_ff_shards` "virtual experts" so the expert count divides the
    # model mesh axis (mixtral: 8 experts x 2 = 16).  Exact: the gated-MLP
    # ff sum partitions cleanly; routing still happens over real experts.
    moe_ff_shards: int = 1

    # --- attention variants ---
    sliding_window: int = 0      # 0 = full attention
    alt_local_global: bool = False  # gemma2: even layers local(SWA), odd global
    attn_softcap: float = 0.0    # gemma2 attn logit softcap
    final_softcap: float = 0.0   # gemma2 final logit softcap
    rope_theta: float = 10000.0

    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0           # N (state size); 0 = no ssm
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0          # >0 = enc-dec; num_layers is decoder depth

    # --- frontends (stubs per instructions) ---
    frontend: str = "none"       # none | patch (vlm) | frames (audio)
    frontend_len: int = 0        # prefix length contributed by the frontend

    # --- misc ---
    tie_embeddings: bool = False
    scale_emb: float = 1.0       # minicpm embeds scaling
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_virtual_experts(self) -> int:
        return self.num_experts * self.moe_ff_shards

    @property
    def virtual_d_ff(self) -> int:
        return self.d_ff // self.moe_ff_shards

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    # --- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ---

    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kvh = self.hd, self.num_heads, self.num_kv_heads
        per_layer = 0
        if self.has_attention:
            per_layer += d * (h * hd) + 2 * d * (kvh * hd) + (h * hd) * d
        if self.has_ssm:
            d_in = self.ssm_expand * d
            n = self.ssm_state
            nh = d_in // self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv
            per_layer += d * (2 * d_in + 2 * n + nh) + d_in * d + d_in * self.ssm_conv
        if self.is_moe:
            e = self.num_experts if not active_only else self.top_k
            per_layer += e * 3 * d * ff + d * self.num_experts  # experts + router
        elif ff > 0:
            per_layer += 3 * d * ff  # gated mlp
        per_layer += 2 * d  # norms
        total = self.num_layers * per_layer
        if self.enc_layers:
            enc_per = d * (h * hd) + 2 * d * (kvh * hd) + (h * hd) * d + 3 * d * ff + 2 * d
            cross = d * (h * hd) + 2 * d * (kvh * hd) + (h * hd) * d + d
            total += self.enc_layers * enc_per + self.num_layers * cross
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four LM shape cells assigned to every architecture.
LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig           # reduced same-family config for CPU tests
    # long_500k applicability (DESIGN.md §4): False for pure full-attention
    supports_long_context: bool = False
    source: str = ""

    @property
    def name(self) -> str:
        return self.config.name

    def shapes(self):
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.supports_long_context:
                continue
            yield s

    def skipped_shapes(self):
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.supports_long_context:
                yield s
