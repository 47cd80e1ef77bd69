"""Unified model configuration covering the full assigned architecture pool,
the PyTorch port of ``repro.models.config``.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM-backbone
transformers; per-layer heterogeneity (jamba's 1:7 mamba:attn interleave,
deepseek-v3's dense-prefix) is expressed with a repeating ``period`` of layer
specs plus an unrolled ``prefix``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


# the dtype strings the configs use -> torch dtypes
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # attn | mamba
    moe: bool = False           # MoE MLP instead of dense MLP
    cross_attn: bool = False    # enc-dec decoder blocks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads

    # --- layer pattern -----------------------------------------------------
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: Tuple[LayerSpec, ...] = ()   # unrolled leading layers (dsv3 dense)

    # --- attention ---------------------------------------------------------
    attn_kind: str = "gqa"               # gqa | mla
    attn_pad_heads: int = 0              # physical head padding for TP
    #   (sharding-layout decision, NOT an architecture change: padded query
    #   heads are hard-masked to zero before the output projection, so the
    #   function computed — and every gradient — is bit-identical to the
    #   unpadded model; see EXPERIMENTS.md §Perf/minitron)
    window: int = 0                      # sliding-window size (0 = full)
    causal: bool = True
    rope: str = "rope"                   # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)   # t/h/w halves

    # --- MLA (deepseek-v3) ---------------------------------------------------
    q_lora_rank: int = 0                 # 0 -> dense q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- MLP / MoE -----------------------------------------------------------
    mlp_kind: str = "swiglu"             # swiglu | mlp (non-gated)
    act: str = "silu"                    # silu | gelu | relu2
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 0                 # 0 -> d_ff
    d_ff_dense: int = 0                  # dense-prefix layers (dsv3: 18432)
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # --- Mamba2 / SSD ----------------------------------------------------------
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- enc-dec ---------------------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_causal: bool = False

    # --- embeddings / norms ------------------------------------------------------
    norm: str = "rmsnorm"                # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    pos_embed: str = "none"              # none | learned  (whisper decoder)
    max_pos: int = 0                     # learned pos table size
    logit_softcap: float = 0.0           # grok-style tanh soft-capping

    # --- modality frontend stub ---------------------------------------------------
    frontend: str = "none"               # none | audio_stub | vision_stub

    # --- numerics ------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- MTP (deepseek-v3 multi-token prediction, optional aux head) -----------------
    mtp_depth: int = 0

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        body = self.n_layers - len(self.prefix)
        assert body >= 0 and body % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} incompatible with "
            f"prefix={len(self.prefix)} + period={len(self.period)}")

    # ------------------------------------------------------------------ helpers
    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.prefix)) // len(self.period)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ff_expert(self) -> int:
        return self.d_ff_expert or self.d_ff

    @property
    def ff_dense(self) -> int:
        return self.d_ff_dense or self.d_ff

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / SWA)."""
        kinds = {s.kind for s in self.prefix + self.period}
        if kinds == {"mamba"}:
            return True
        if "mamba" in kinds:
            return True                   # hybrid: attn layers still cache S
        return self.window > 0            # sliding window attention

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return self.prefix + self.period * self.n_periods

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline N."""
        d, dh = self.d_model, self.d_head
        total = self.vocab * d                      # embed
        if not self.tie_embeddings:
            total += d * self.vocab                 # lm head
        if self.pos_embed == "learned" and self.max_pos:
            total += self.max_pos * d

        def attn_params() -> int:
            if self.attn_kind == "mla":
                qk = self.qk_nope_dim + self.qk_rope_dim
                p = 0
                if self.q_lora_rank:
                    p += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
                else:
                    p += d * self.n_heads * qk
                p += d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            return d * self.n_heads * dh + 2 * d * self.n_kv * dh + self.n_heads * dh * d

        def mlp_params(ff: int) -> int:
            mults = 3 if self.mlp_kind == "swiglu" else 2
            return mults * d * ff

        def mamba_params() -> int:
            din, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = din + 2 * self.ssm_groups * ns
            p = d * (2 * din + 2 * self.ssm_groups * ns + nh)   # in_proj
            p += conv_dim * self.ssm_conv                        # conv
            p += nh * 2 + nh                                     # A, D, dt_bias
            p += din * d                                          # out_proj
            return p

        for i, spec in enumerate(self.layer_specs()):
            is_prefix = i < len(self.prefix)
            if spec.kind == "mamba":
                total += mamba_params()
            else:
                total += attn_params()
                if spec.cross_attn:
                    total += attn_params()
            if spec.moe:
                e = self.n_experts + self.n_shared_experts
                total += e * mlp_params(self.ff_expert) + d * self.n_experts
            else:
                total += mlp_params(self.ff_dense if is_prefix else self.d_ff)
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += attn_params() + mlp_params(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k), for MODEL_FLOPS = 6·N_active·D."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        mults = 3 if self.mlp_kind == "swiglu" else 2
        per_expert = mults * d * self.ff_expert
        inactive = (self.n_experts - self.top_k) * per_expert
        n_moe_layers = sum(s.moe for s in self.layer_specs())
        return self.param_count() - n_moe_layers * inactive
