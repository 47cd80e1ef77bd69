"""Qwen2-VL-2B [arXiv:2409.12191; hf].

Dense decoder with M-RoPE (multimodal rotary: t/h/w frequency sections of
the 64 half-dims split 16/24/24). The vision ViT frontend is a STUB:
input_specs() provides token ids plus 3-channel position ids from the
dynamic-resolution patchifier. Tied embeddings (vocab 151936 dominates the
2B budget).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    period=(LayerSpec(),),
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    mlp_kind="swiglu",
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    frontend="vision_stub",
)

REDUCED = ModelConfig(
    name="qwen2-vl-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    period=(LayerSpec(),),
    rope="mrope",
    mrope_sections=(2, 3, 3),
    mlp_kind="swiglu",
    tie_embeddings=True,
    frontend="vision_stub",
)
