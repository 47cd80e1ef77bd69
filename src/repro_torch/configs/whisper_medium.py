"""Whisper-medium (769M) [arXiv:2212.04356; unverified].

Encoder-decoder: 24 encoder + 24 decoder layers, d=1024, 16 heads (MHA),
GELU MLP (non-gated), LayerNorm, sinusoidal positions, no RoPE. The audio
conv frontend is a STUB per the task: input_specs() provides precomputed
frame embeddings (B, S_enc, d_model); `enc_in_proj` stands in for the conv
stack's output projection.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    period=(LayerSpec(cross_attn=True),),
    enc_dec=True,
    n_enc_layers=24,
    mlp_kind="mlp",
    act="gelu",
    norm="layernorm",
    rope="none",
    pos_embed="sinusoidal",
    frontend="audio_stub",
)

REDUCED = ModelConfig(
    name="whisper-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=128,
    vocab=256,
    period=(LayerSpec(cross_attn=True),),
    enc_dec=True,
    n_enc_layers=2,
    mlp_kind="mlp",
    act="gelu",
    norm="layernorm",
    rope="none",
    pos_embed="sinusoidal",
    frontend="audio_stub",
)
