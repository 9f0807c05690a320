"""Architecture registry of the port (counterpart of ``repro/configs``).

``--arch <id>`` resolves through ``get(id)``.  The configs are plain
dataclasses, copied from the reference.  Its ``input_specs`` /
``cache_specs`` / ``param_specs`` are shape tools of the dry run and are
not ported yet (ROADMAP Queue A item 14).
"""
from __future__ import annotations

import importlib

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
