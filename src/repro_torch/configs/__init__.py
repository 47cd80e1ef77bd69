"""Architecture registry: one module per assigned architecture, the
PyTorch port of ``repro.configs`` (the same values, pure data).

``get(name)`` returns the full published ModelConfig; ``get_reduced(name)``
returns the same family scaled down for CPU smoke tests (few layers, narrow
width, few experts, tiny vocab). Shapes live in .shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "jamba_1_5_large_398b",
    "whisper_medium",
    "qwen2_vl_2b",
    "minitron_4b",
    "h2o_danube_3_4b",
    "deepseek_7b",
    "olmo_1b",
    "deepseek_v3_671b",
    "grok_1_314b",
    "mamba2_1_3b",
)

# dashes-to-underscores aliases used on CLIs
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return name


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
