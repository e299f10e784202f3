"""Architecture registry: one module per assigned architecture (port of
``repro.configs``, config for config).

``get_config(name)`` returns the full published config; ``get_config(name,
reduced=True)`` returns the smoke-test sibling (same family and feature
flags, tiny dims).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell

ARCH_IDS = [
    "gemma2_2b",
    "qwen3_0_6b",
    "stablelm_1_6b",
    "qwen2_5_14b",
    "granite_moe_1b_a400m",
    "qwen2_moe_a2_7b",
    "internvl2_2b",
    "seamless_m4t_large_v2",
    "zamba2_1_2b",
    "rwkv6_1_6b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def all_configs() -> dict[str, ModelConfig]:
    return {i: get_config(i) for i in ARCH_IDS}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeCell]:
    """The assigned shape cells this arch runs (long_500k only for
    sub-quadratic archs, per DESIGN.md §5)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        cells.append(SHAPES["long_500k"])
    return cells
