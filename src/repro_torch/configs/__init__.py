"""Architecture registry of the port (counterpart of ``repro/configs``).

``--arch <id>`` resolves through ``get(id)``.  The configs are plain
dataclasses, copied from the reference.  ``input_specs`` /
``cache_specs`` / ``param_specs`` are the dry run's view of the data:
tensors that allocate nothing, on ``device="meta"`` (the default) or, on
any device, under ``FakeTensorMode``.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    SHAPES_BY_NAME,
    ArchSpec,
    ModelConfig,
    ShapeConfig,
)

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "dbrx-132b": "dbrx_132b",
    "hymba-1.5b": "hymba_1p5b",
    "internvl2-2b": "internvl2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "stablelm-3b": "stablelm_3b",
    "gemma2-2b": "gemma2_2b",
    "minicpm-2b": "minicpm_2b",
    "deepseek-7b": "deepseek_7b",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SPEC


def all_specs():
    return [get(a) for a in ARCH_IDS]


# ---------------------------------------------------------------------------
# specs: tensors that allocate nothing
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """Abstract inputs for one (arch x shape) cell.

    train/prefill: {tokens, labels?, prefix_embeds?, enc_embeds?}
    decode:        {token, pos} (the KV/state cache comes from cache_specs).
    Frontend stubs: precomputed patch/frame embeddings, as the reference's.
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"token": spec((b,), torch.int32),
                "pos": spec((b,), torch.int32)}
    specs = {}
    s_tok = s
    if cfg.frontend == "patch":
        s_tok = s - cfg.frontend_len
        specs["prefix_embeds"] = spec((b, cfg.frontend_len, cfg.d_model),
                                      torch.bfloat16)
    if cfg.enc_layers > 0:
        s_tok = s // 2
        specs["enc_embeds"] = spec((b, s - s_tok, cfg.d_model),
                                   torch.bfloat16)
    specs["tokens"] = spec((b, s_tok), torch.int32)
    if shape.kind == "train":
        specs["labels"] = spec((b, s), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Abstract decode cache (``models.lm.init_cache``'s layout)."""
    from repro_torch.models import lm

    return lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device=device)


def param_specs(cfg: ModelConfig, device="meta"):
    """Abstract parameters: an ``LM`` whose weights are empty tensors
    (``lm.init_params(empty=True)``), one per layer; ``lm.tree_paths``
    maps them onto the reference's stacked tree."""
    from repro_torch.models import lm

    return lm.init_params(cfg, device=device, empty=True)
