"""Per (arch, shape) layout overrides and the mesh strategies, the port
of ``repro.launch.tuning``.

Each ``TUNED`` entry is a ``dataclasses.replace()`` kwargs dict applied to
the published ``ModelConfig``, plus an optional "mesh_strategy".  The
entries change layout and schedule only, never the computed function
(``attn_pad_heads`` zero-masks the padded heads).  The reasons are the
reference's, measured on its TPU meshes.
"""
from __future__ import annotations

from typing import Optional

from ..models import sharding
from ..models.config import ModelConfig

# (arch, shape) -> ModelConfig replace() kwargs (+ "mesh_strategy").
# "*" entries apply first; shape-specific entries override them.
TUNED: dict[tuple[str, str], dict] = {
    # 24 heads % 16-way TP != 0 made GSPMD shard head_dim, turning QK^T into
    # a partial sum with a (B,H,S,S) logits all-reduce.  Padding 24->32
    # heads (zero-masked, bit-exact) restores head sharding.
    ("minitron_4b", "*"): {"attn_pad_heads": 32},
    # Same pathology: 12 heads -> pad to 16.
    ("qwen2_vl_2b", "*"): {"attn_pad_heads": 16},
    # 4B params x 1M-token batch is the FSDP regime: batch over both mesh
    # axes, params fully sharded, no TP -> per-layer param all-gathers
    # replace residual-stream all-reduces, and no head padding is needed.
    ("minitron_4b", "train_4k"): {"attn_pad_heads": 0,
                                  "mesh_strategy": "fsdp"},
    ("qwen2_vl_2b", "train_4k"): {"attn_pad_heads": 0,
                                  "mesh_strategy": "fsdp"},
}

STRATEGIES = ("2d", "fsdp")


def overrides_for(arch: str, shape: str) -> Optional[dict]:
    out: dict = {}
    for (a, s), kw in TUNED.items():
        if a == arch and s == "*":
            out.update(kw)
    for (a, s), kw in TUNED.items():
        if a == arch and s == shape:
            out.update(kw)
    return out or None


def mesh_specs(params, cfg: ModelConfig, mesh, batch: int,
               strategy: str = "2d") -> tuple[dict, tuple]:
    """(parameter specs, token-batch spec) of a mesh strategy: "2d" is
    FSDP over ``data`` and tensor parallelism over ``model``
    (``param_specs``, ``data_specs``); "fsdp" shards the weights over
    every axis with no tensor parallelism, and the batch over every axis
    that divides it."""
    if strategy == "2d":
        return (sharding.param_specs(params, cfg, mesh),
                sharding.data_specs(cfg, mesh, batch))
    if strategy == "fsdp":
        axes = tuple(mesh.shape)
        return (sharding.param_specs(params, cfg, mesh, fsdp_axis=axes,
                                     model_axis=None),
                sharding.data_specs(cfg, mesh, batch, axes=axes))
    raise ValueError(f"mesh strategy {strategy!r}: one of {STRATEGIES}")
