"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437; hf].

61 layers: 3 dense prefix layers (d_ff 18432) + 58 MoE layers with 1 shared
+ 256 routed experts (top-8, expert d_ff 2048). Multi-head Latent Attention:
q LoRA rank 1536, kv LoRA rank 512, qk nope/rope 128/64, v head 128 — the KV
cache stores only 512+64 values per token. Depth-1 multi-token-prediction
auxiliary head enabled for training (matches the release; serving cells do
not lower it).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_head=128,
    d_ff=2048,              # routed-expert FFN width (assigned config)
    vocab=129280,
    prefix=(LayerSpec(),) * 3,
    period=(LayerSpec(moe=True),),
    d_ff_dense=18432,
    d_ff_expert=2048,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mlp_kind="swiglu",
    act="silu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=10000.0,
    mtp_depth=1,
)

REDUCED = ModelConfig(
    name="dsv3-reduced",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=64,
    vocab=512,
    prefix=(LayerSpec(),),
    period=(LayerSpec(moe=True),),
    d_ff_dense=128,
    d_ff_expert=64,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    attn_kind="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    mtp_depth=1,
)
