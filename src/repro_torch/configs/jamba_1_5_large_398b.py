"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887 / 2408.12570; hf].

Hybrid Mamba+attention 1:7 interleave with MoE every other layer:
period of 8 = [attn, mamba x7], MoE on odd positions (4 MoE layers per
period, 16 experts top-2). 72 layers = 9 periods.

Adaptation note (DESIGN.md §6): Jamba ships Mamba-1 selective-scan blocks;
we implement the SSD (Mamba-2) formulation — same state-space interface,
MXU-friendlier chunked algorithm.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec(kind=("attn" if i == 0 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    period=_PERIOD,
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    rope="rope",           # attn layers use RoPE
    mlp_kind="swiglu",
    act="silu",
    norm="rmsnorm",
)

REDUCED = ModelConfig(
    name="jamba-reduced",
    n_layers=8,
    d_model=128,
    n_heads=4,
    n_kv=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    period=tuple(
        LayerSpec(kind=("attn" if i == 0 else "mamba"), moe=(i % 2 == 1))
        for i in range(4)
    ),
    n_experts=4,
    top_k=2,
    d_ff_expert=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=8,
)
