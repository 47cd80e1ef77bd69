"""DeepSeek-LLM-7B [arXiv:2401.02954; hf].

Llama-architecture dense decoder: 30L x d4096, full MHA (kv=32), swiglu,
vocab 102400.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_head=128,
    d_ff=11008,
    vocab=102400,
    period=(LayerSpec(),),
    mlp_kind="swiglu",
    act="silu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="deepseek7b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=160,
    vocab=512,
    period=(LayerSpec(),),
    mlp_kind="swiglu",
)
