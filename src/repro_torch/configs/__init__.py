"""Architecture registry: ``--arch <id>`` resolves here.

This slice registers the dense family; the other families' configs come
with their models (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    cell_is_applicable,
)

_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "qwen3-8b": "qwen3_8b",
    "granite-34b": "granite_34b",
    "qwen2-72b": "qwen2_72b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
