"""Minitron-4B (pruned Nemotron-4) [arXiv:2407.14679; hf].

Dense decoder, 32L x d3072, 24 heads (GQA kv=8, head dim 128), squared-ReLU
non-gated MLP (Nemotron family), huge 256000 vocab (tied per the release).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_head=128,
    d_ff=9216,
    vocab=256000,
    period=(LayerSpec(),),
    mlp_kind="mlp",
    act="relu2",
    norm="layernorm",
    rope="rope",
    rope_theta=10000.0,
    tie_embeddings=False,   # untied: 3.40B blocks + 0.79B x2 embed = 4.19B
)

REDUCED = ModelConfig(
    name="minitron-reduced",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv=2,
    d_head=16,
    d_ff=192,
    vocab=1024,
    period=(LayerSpec(),),
    mlp_kind="mlp",
    act="relu2",
    norm="layernorm",
    tie_embeddings=True,
)
