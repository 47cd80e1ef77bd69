"""Transformer building blocks, the PyTorch port of
``repro.models.layers``: norms, rotary embeddings (RoPE, M-RoPE),
grouped-query / sliding-window self-attention with a decode cache,
cross-attention over an encoder's output, DeepSeek-V3's Multi-head Latent
Attention with its latent cache, dense MLPs.

Each block's parameters live in a small ``nn.Module`` (``Norm``,
``Attention``, ``MLAttention``, ``MLP``) under the reference's names
(``scale``/``bias``, ``wq``/``wk``/``wv``/``wo``, ``wq_a``/``q_norm``/
``wq_b``/``wkv_a``/``kv_norm``/``wkv_b``/``wo``, ``wi``/``wg``/``wo``); the
functions take that module where the reference takes its parameter dict.
Norm statistics and the softmax run in float32 whatever the compute
dtype, and the casts sit where the reference's ``astype`` calls sit,
since that is where bf16 results are rounded.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import floatops
from .config import ModelConfig

INIT_SCALE = 0.02


def _param(t: torch.Tensor) -> nn.Parameter:
    # no autograd graph for serving; training turns requires_grad on
    return nn.Parameter(t, requires_grad=False)


def _normal_init(shape, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device: torch.device, dtype=None) -> nn.Parameter:
    """The reference's ``_norm_init``: N(0, 1) in float32, cast to the
    parameter dtype (or ``dtype``), then scaled by 0.02 in that dtype.
    Without a generator the tensor is left uninitialised (``convert``
    fills it)."""
    dtype = dtype or cfg.pdtype
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return _param(x.to(dtype) * INIT_SCALE)


def _scaled_f32_init(shape, cfg: ModelConfig, gen: Optional[torch.Generator],
                     device: torch.device) -> nn.Parameter:
    """N(0, 1) in float32 scaled by 0.02, then cast to the parameter dtype
    (the reference's embeddings, ``enc_in_proj`` and Mamba projections
    scale before the cast); uninitialised without a generator."""
    if gen is None:
        return _param(torch.empty(shape, dtype=cfg.pdtype, device=device))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return _param((x * INIT_SCALE).to(cfg.pdtype))


# ----------------------------------------------------------------- norms
class Norm(nn.Module):
    """``scale`` (rmsnorm, layernorm) and ``bias`` (layernorm); OLMo's
    non-parametric LayerNorm holds nothing."""

    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = _param(torch.ones(d, dtype=cfg.pdtype,
                                           device=device))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros(d, dtype=cfg.pdtype,
                                           device=device))


def init_norm(cfg: ModelConfig, d: int, device=None) -> Norm:
    return Norm(cfg, d, device)


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 statistics, eps 1e-6, the biased variance; back in x's
    dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        y = y * p.scale.to(torch.float32)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        if cfg.norm == "layernorm":
            y = y * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    return y.to(x.dtype)


# ------------------------------------------------------------------ rope
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    exps = exps / floatops.const(dim, exps)
    return floatops.const(1.0, exps) / torch.pow(floatops.const(theta, exps),
                                                 exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Split halves (not interleaved) rotated by ``ang`` (B, S, dh/2)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), positions (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) for (t, h, w); the
    dh/2 frequency slots are split into t/h/w sections."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                 # (half,)
    ang = positions3.to(torch.float32)[sec_id]            # (half, B, S)
    return _rotate(x, torch.movedim(ang, 0, -1) * freqs)


def _inv_timescales(d: int, device=None) -> torch.Tensor:
    """(d/2,) ``10000 ** (2 dim / d)`` in float32, the reference's traced
    power (``floatops.powf``)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    expo = (2 * dim) / floatops.const(d, dim)
    return floatops.powf(floatops.const(10000.0, expo), expo)


def _sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) positions -> (B, S, d) float32 sinusoidal embeddings: the
    sines of pos / 10000^(2i/d), then their cosines."""
    ang = (positions[..., None].to(torch.float32)
           / _inv_timescales(d, positions.device))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _sinusoidal(s: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32 sinusoidal embeddings of positions 0 .. S-1."""
    return _sinusoidal_at(torch.arange(s, device=device)[None], d)[0]


def positions_like(tokens: torch.Tensor, offset=0) -> torch.Tensor:
    """(1, S) int32 positions ``offset .. offset + S - 1``."""
    s = tokens.shape[1]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None, :] + offset


# ------------------------------------------------------------- attention
class Attention(nn.Module):
    """GQA projections: wq (d, Hp, Dh), wk/wv (d, KV, Dh), wo (Hp, Dh, d);
    Hp = ``attn_pad_heads`` or n_heads."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
        hp = cfg.attn_pad_heads or h
        assert hp >= h
        self.wq = _normal_init((d, hp, dh), cfg, generator, device)
        self.wk = _normal_init((d, kv, dh), cfg, generator, device)
        self.wv = _normal_init((d, kv, dh), cfg, generator, device)
        self.wo = _normal_init((hp, dh, d), cfg, generator, device)
        if hp > h and generator is not None:
            # padded head slices start (and stay) exactly zero
            self.wq.data[:, h:, :] = 0
            self.wo.data[h:, :, :] = 0


class MLAttention(nn.Module):
    """MLA projections: ``wq_a`` (d, q_rank), ``q_norm`` (q_rank,),
    ``wq_b`` (q_rank, H * (nope + rope)), or ``wq`` (d, H * (nope + rope))
    when ``q_lora_rank`` is 0; ``wkv_a`` (d, kv_rank + rope), ``kv_norm``
    (kv_rank,), ``wkv_b`` (kv_rank, H * (nope + v)), ``wo`` (H * v, d)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora_rank:
            self.wq_a = _normal_init((d, cfg.q_lora_rank), cfg, generator,
                                     device)
            self.q_norm = _param(torch.ones(cfg.q_lora_rank,
                                            dtype=cfg.pdtype, device=device))
            self.wq_b = _normal_init((cfg.q_lora_rank, h * qk), cfg,
                                     generator, device)
        else:
            self.wq = _normal_init((d, h * qk), cfg, generator, device)
        self.wkv_a = _normal_init((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                                  cfg, generator, device)
        self.kv_norm = _param(torch.ones(cfg.kv_lora_rank, dtype=cfg.pdtype,
                                         device=device))
        self.wkv_b = _normal_init(
            (cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim)), cfg,
            generator, device)
        self.wo = _normal_init((h * cfg.v_head_dim, d), cfg, generator,
                               device)


def init_attention(cfg: ModelConfig, generator=None, device=None):
    """``MLAttention`` when ``cfg.attn_kind`` is "mla", else ``Attention``."""
    if cfg.attn_kind == "mla":
        return MLAttention(cfg, generator, device)
    return Attention(cfg, generator, device)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], softcap: float = 0.0
          ) -> torch.Tensor:
    """q (B,S,H,Dh), k/v (B,T,H,Dh) already head-expanded. f32 softmax."""
    dh = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    logits = logits / floatops.sqrt(floatops.const(dh, logits))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / floatops.const(softcap,
                                                              logits))
    if mask is not None:
        logits = torch.where(mask, logits, floatops.const(-1e30, logits))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _expand_kv(k: torch.Tensor, n_heads: int,
               cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """(B,T,KV,Dh) -> (B,T,Hp,Dh) by GQA group mapping.

    With head padding, the logical group mapping (head i -> kv i // (H/KV))
    is kept for the real heads; padded heads reuse group 0 (their output is
    hard-masked anyway)."""
    kvh = k.shape[2]
    hp = n_heads
    h_logical = cfg.n_heads if cfg is not None else n_heads
    if kvh == hp:
        return k
    if hp == h_logical:
        return torch.repeat_interleave(k, hp // kvh, dim=2)
    idx = torch.cat([
        torch.arange(h_logical, device=k.device) // max(h_logical // kvh, 1),
        torch.zeros(hp - h_logical, dtype=torch.int64, device=k.device)])
    return k[:, :, idx, :]


def _head_mask(cfg: ModelConfig, hp: int, dtype,
               device=None) -> Optional[torch.Tensor]:
    """(Hp,) 1.0 for logical heads, 0.0 for padding (None when unpadded)."""
    if hp == cfg.n_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.n_heads).to(dtype)


def causal_mask(s: int, t: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,S,T) boolean; query i attends key j iff j <= i+offset and within
    the sliding window when window > 0."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m[None, None]


def _write_cache(buf: torch.Tensor, new: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(buf, new, idx, 1)``: a new buffer,
    the start clamped so that the slice fits, as XLA clamps it."""
    t, s = buf.shape[1], new.shape[1]
    rows = torch.clamp(idx, 0, t - s) + torch.arange(s, device=buf.device)
    return buf.index_copy(1, rows, new)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, cache: Optional[dict] = None,
              kv_src: Optional[torch.Tensor] = None,
              is_cross: bool = False) -> tuple[torch.Tensor, Optional[dict]]:
    """Self-attention over the whole sequence (``cache`` None) or decode of
    the new token(s) into a cache; cross-attention over ``kv_src``.

    cache: {"k": (B,T,KV,Dh), "v": ..., "len": 0-d int32}; a ring buffer
    of the last ``cfg.window`` keys when T == cfg.window (SWA decode
    state is O(window)), else a linear cache written at ``len``.  The
    returned cache is new; the one passed in is left as it was.

    Cross-attention (``kv_src`` given or ``is_cross``): keys and values
    are the cache's {"k", "v"} (B, T_enc, KV, Dh) when it holds them,
    else ``kv_src`` (B, T_enc, d) projected by ``wk``/``wv``; no mask, no
    rotary embedding; returns that {"k", "v"} as the cache.
    """
    b, s, d = x.shape
    hp = p.wq.shape[1]                          # physical (maybe padded) heads
    ct = cfg.cdtype
    hmask = _head_mask(cfg, hp, ct, x.device)
    xc = x.to(ct)
    q = torch.einsum("bsd,dhk->bshk", xc, p.wq.to(ct))

    def project_out(out):
        if hmask is not None:                   # zero padded heads: exact
            out = out * hmask[None, None, :, None]
        return torch.einsum("bshd,hdk->bsk", out, p.wo.to(ct))

    if kv_src is not None or is_cross:
        if cache is not None and "k" in cache:
            k, v = cache["k"], cache["v"]
        else:
            src = kv_src.to(ct)
            k = torch.einsum("btd,dhk->bthk", src, p.wk.to(ct))
            v = torch.einsum("btd,dhk->bthk", src, p.wv.to(ct))
        out = _sdpa(q, _expand_kv(k, hp, cfg), _expand_kv(v, hp, cfg), None,
                    cfg.logit_softcap)
        return project_out(out), {"k": k, "v": v}

    k = torch.einsum("bsd,dhk->bshk", xc, p.wk.to(ct))
    v = torch.einsum("bsd,dhk->bshk", xc, p.wv.to(ct))
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)

    if cache is None:                           # full sequence (prefill)
        mask = (causal_mask(s, s, 0, cfg.window, x.device) if cfg.causal
                else None)
        ck, cv, new_cache = k, v, None
    else:                                       # decode
        t = cache["k"].shape[1]
        kj = torch.arange(t, device=x.device)[None, None, None, :]
        if cfg.window > 0 and t == cfg.window:  # O(window) ring buffer
            # roll left by one, the newest entry in slot t-1
            ck = torch.cat([cache["k"][:, 1:], k[:, :1]], 1)
            cv = torch.cat([cache["v"][:, 1:], v[:, :1]], 1)
            # valid slots are the last len+1
            mask = kj >= (t - torch.clamp(cache["len"] + 1, max=t))
        else:
            idx = cache["len"]
            ck = _write_cache(cache["k"], k, idx)
            cv = _write_cache(cache["v"], v, idx)
            mask = kj <= idx
            if cfg.window > 0:
                mask &= kj > idx - cfg.window
        new_cache = {"k": ck, "v": cv, "len": cache["len"] + 1}
    out = _sdpa(q, _expand_kv(ck, hp, cfg), _expand_kv(cv, hp, cfg), mask,
                cfg.logit_softcap)
    return project_out(out), new_cache


def mla_attention(p: MLAttention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, cache: Optional[dict] = None
                  ) -> tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek-V3 Multi-head Latent Attention over the whole sequence
    (``cache`` None) or decode into the latent cache.

    cache: {"ckv": (B, T, kv_lora_rank), "k_rope": (B, T, 1, qk_rope_dim),
    "len": 0-d int32}: only the normalised latent and the shared rope key
    are kept, and ``wkv_b`` decompresses the whole cache each step, as the
    reference does.  The returned cache is new.
    """
    b, s, d = x.shape
    h = cfg.n_heads
    ct = cfg.cdtype
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    xc = x.to(ct)

    if cfg.q_lora_rank:
        ql = _rms(xc @ p.wq_a.to(ct), p.q_norm)
        q = (ql @ p.wq_b.to(ct)).reshape(b, s, h, nope + rdim)
    else:
        q = (xc @ p.wq.to(ct)).reshape(b, s, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = xc @ p.wkv_a.to(ct)                         # (B, S, rank + rdim)
    ckv = _rms(kv_a[..., :cfg.kv_lora_rank], p.kv_norm)
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)                # (B, S, 1, rdim)

    if cache is not None:
        idx = cache["len"]
        ckv = _write_cache(cache["ckv"], ckv, idx)
        k_rope = _write_cache(cache["k_rope"], k_rope, idx)
        new_cache = {"ckv": ckv, "k_rope": k_rope, "len": cache["len"] + 1}
        t = ckv.shape[1]
        mask = torch.arange(t, device=x.device)[None, None, None, :] <= idx
    else:
        new_cache = None
        t = s
        mask = causal_mask(s, s, device=x.device) if cfg.causal else None

    kvb = (ckv @ p.wkv_b.to(ct)).reshape(b, t, h, nope + vdim)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(b, t, h, rdim)], -1)
    logits = torch.einsum("bshd,bthd->bhst", qf, kf).to(torch.float32)
    logits = logits / floatops.sqrt(floatops.const(nope + rdim, logits))
    if mask is not None:
        logits = torch.where(mask, logits, floatops.const(-1e30, logits))
    probs = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * vdim)
    return out @ p.wo.to(ct), new_cache


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm in float32 (eps 1e-6, the scale in float32), back in x's
    dtype."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------- MLPs
class MLP(nn.Module):
    """swiglu: wi, wg (d, d_ff), wo (d_ff, d); mlp: wi, wo."""

    def __init__(self, cfg: ModelConfig, d_ff: int, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.wi = _normal_init((d, d_ff), cfg, generator, device)
        if cfg.mlp_kind == "swiglu":
            self.wg = _normal_init((d, d_ff), cfg, generator, device)
        self.wo = _normal_init((d_ff, d), cfg, generator, device)


def init_mlp(cfg: ModelConfig, d_ff: int, generator=None,
             device=None) -> MLP:
    return MLP(cfg, d_ff, generator, device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: ``x * (1 / (1 + exp(-x)))``,
    each operation rounded in x's dtype (bitwise at bf16 on the CPU;
    ``torch.nn.functional.silu`` rounds once from float32, and with it
    the reduced jamba's bf16 greedy tokens leave the reference's).  Five
    elementwise launches where ``F.silu`` is one: PERF.md's findings
    have their cost on a decode step."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return silu(x)
    if act == "gelu":           # jax.nn.gelu's default is the tanh form
        return nn.functional.gelu(x, approximate="tanh")
    if act == "relu2":          # nemotron/minitron squared relu
        r = torch.relu(x)
        return r * r
    raise ValueError(act)


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.cdtype
    xc = x.to(ct)
    if cfg.mlp_kind == "swiglu":
        hdn = _act(xc @ p.wg.to(ct), cfg.act) * (xc @ p.wi.to(ct))
    else:
        hdn = _act(xc @ p.wi.to(ct), cfg.act)
    return hdn @ p.wo.to(ct)
