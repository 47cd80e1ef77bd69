"""OLMo-1B [arXiv:2402.00838; hf].

Dense decoder with **non-parametric LayerNorm** (no scale/bias — the OLMo
signature), full MHA, swiglu, tied embeddings, vocab 50304.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=8192,
    vocab=50304,
    period=(LayerSpec(),),
    mlp_kind="swiglu",
    act="silu",
    norm="nonparam_ln",
    rope="rope",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="olmo-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=128,
    vocab=256,
    period=(LayerSpec(),),
    norm="nonparam_ln",
    tie_embeddings=True,
)
