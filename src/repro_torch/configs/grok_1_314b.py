"""Grok-1 (314B, 8 experts top-2) [hf:xai-org/grok-1; unverified].

64L x d6144, 48 heads (GQA kv=8, head dim 128), every layer MoE with 8
experts top-2 (expert d_ff 32768), GeGLU, 30.0 output logit soft-cap,
vocab 131072.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    period=(LayerSpec(moe=True),),
    n_experts=8,
    top_k=2,
    d_ff_expert=32768,
    mlp_kind="swiglu",
    act="gelu",             # GeGLU
    norm="rmsnorm",
    rope="rope",
    logit_softcap=30.0,
)

REDUCED = ModelConfig(
    name="grok-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(moe=True),),
    n_experts=4,
    top_k=2,
    d_ff_expert=128,
    mlp_kind="swiglu",
    act="gelu",
    logit_softcap=30.0,
)
