"""H2O-Danube-3-4B [arXiv:2401.16818 family; unverified].

Llama/Mistral mix: dense decoder with sliding-window attention (Mistral
window 4096), GQA kv=8, swiglu, 32000 vocab. SWA makes it eligible for the
long_500k decode cell with an O(window) ring-buffer KV cache.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv=8,
    d_head=120,
    d_ff=10240,
    vocab=32000,
    period=(LayerSpec(),),
    window=4096,
    mlp_kind="swiglu",
    act="silu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="danube-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    period=(LayerSpec(),),
    window=16,
    mlp_kind="swiglu",
)
