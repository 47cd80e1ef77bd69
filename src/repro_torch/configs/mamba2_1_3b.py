"""Mamba2-1.3B [arXiv:2405.21060; unverified].

Pure SSM (attention-free, no MLP blocks): 48 SSD layers, d=2048 (d_inner
4096, 64 heads x head_dim 64, state 128), vocab 50280, tied embeddings.
The d_ff=0 assignment means blocks are mamba-only — the model config
drops the MLP sublayer entirely.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=1,               # attention-free; unused
    n_kv=1,
    d_head=1,
    d_ff=0,                  # no MLP sublayer (pure mamba stack)
    vocab=50280,
    period=(LayerSpec(kind="mamba"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    norm="rmsnorm",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-reduced",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv=1,
    d_head=1,
    d_ff=0,
    vocab=256,
    period=(LayerSpec(kind="mamba"),),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=8,
    tie_embeddings=True,
)
