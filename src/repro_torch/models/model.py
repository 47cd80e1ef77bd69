"""Model assembly for the decoders, the serving half of
``repro.models.model``: embeddings, the layer stack (dense or MoE MLPs,
GQA or MLA attention), logits, the decode cache, ``decode_step`` and
``prefill``.

The reference stacks the periodic body's parameters over periods and runs
it under ``lax.scan``, a compile-time idiom of XLA.  Here the body is an
``nn.ModuleList`` unrolled in ``cfg.layer_specs()`` order and a Python
loop runs it; ``convert`` carries the stacked tree across.  Decode caches
follow the same unrolled layout: a list with one entry per layer.

A config that needs a family still to port (Mamba, encoder-decoder)
raises ``NotImplementedError`` naming its ROADMAP item, and so does
training (``loss_fn``, item 18.5).  deepseek-v3's multi-token-prediction
head (``Model.mtp``) is built and carried by ``convert``; serving does not
run it, as the reference's does not.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import device as _device
from ..core import floatops
from . import layers, moe
from .config import LayerSpec, ModelConfig

SSM_ITEM = "ROADMAP item 18.3 (Mamba/SSM)"
TRAIN_ITEM = "ROADMAP item 18.5 (training)"


def missing_families(cfg: ModelConfig) -> list[str]:
    """What ``cfg`` needs that the port does not have yet, each with its
    ROADMAP item; empty for a decoder of attention layers."""
    specs = cfg.prefix + cfg.period
    out = []
    if any(s.kind == "mamba" for s in specs):
        out.append(f"Mamba layers: {SSM_ITEM}")
    if (cfg.enc_dec or any(s.cross_attn for s in specs)
            or cfg.pos_embed == "sinusoidal"):
        out.append(f"the encoder, cross-attention and sinusoidal positions: "
                   f"{layers.CROSS_ITEM}")
    return out


def check_supported(cfg: ModelConfig) -> None:
    missing = missing_families(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name} is not ported yet: it needs " + "; ".join(missing))


class Layer(nn.Module):
    """One decoder layer of ``spec``: ``ln1``, ``attn`` (GQA, or MLA when
    ``cfg.attn_kind`` is "mla"), then ``ln2`` and ``moe`` for a MoE spec,
    or ``ln2`` and ``mlp`` of width ``d_ff`` when cfg.d_ff > 0."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, d_ff: int,
                 generator=None, device=None):
        super().__init__()
        self.spec = spec
        self.ln1 = layers.init_norm(cfg, cfg.d_model, device)
        self.attn = layers.init_attention(cfg, generator, device)
        if spec.moe:
            self.ln2 = layers.init_norm(cfg, cfg.d_model, device)
            self.moe = moe.init_moe(cfg, generator, device)
        elif cfg.d_ff > 0:
            self.ln2 = layers.init_norm(cfg, cfg.d_model, device)
            self.mlp = layers.init_mlp(cfg, d_ff, generator, device)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: Optional[dict] = None
                ) -> tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
        """The reference's ``_apply_layer`` for an attention layer ->
        (x, new cache or None, the MoE aux loss 0-d float32 or, without
        MoE, None: the reference's zero)."""
        aux = None
        h = layers.apply_norm(self.ln1, x, cfg)
        attend = (layers.mla_attention if cfg.attn_kind == "mla"
                  else layers.attention)
        out, c = attend(self.attn, h, cfg, positions,
                        None if cache is None else cache["attn"])
        x = x + out
        if self.spec.moe:
            h2 = layers.apply_norm(self.ln2, x, cfg)
            mout, aux = moe.moe_layer(self.moe, h2, cfg)
            x = x + mout
        elif cfg.d_ff > 0:
            h2 = layers.apply_norm(self.ln2, x, cfg)
            x = x + layers.mlp(self.mlp, h2, cfg)
        return x, (None if cache is None else {"attn": c}), aux


class MTP(nn.Module):
    """deepseek-v3's depth-1 multi-token-prediction head: ``proj`` (2d,
    d), ``block`` (a dense layer of width ``d_ff``) and ``norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        self.proj = layers._normal_init((2 * d, d), cfg, generator, device)
        self.block = Layer(LayerSpec(), cfg, cfg.d_ff, generator, device)
        self.norm = layers.init_norm(cfg, d, device)


class Model(nn.Module):
    """``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) when untied,
    ``prefix`` (the unrolled leading layers, dense of width
    ``cfg.ff_dense``), ``blocks`` (the periodic body, unrolled) and
    ``mtp`` when ``cfg.mtp_depth``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _embedding((cfg.vocab, d), cfg, generator, device)
        self.final_norm = layers.init_norm(cfg, d, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _embedding((d, cfg.vocab), cfg, generator, device))
        self.prefix = nn.ModuleList(
            Layer(spec, cfg, cfg.ff_dense, generator, device)
            for spec in cfg.prefix)
        self.blocks = nn.ModuleList(
            Layer(spec, cfg, cfg.d_ff, generator, device)
            for spec in cfg.period * cfg.n_periods)
        self.mtp = MTP(cfg, generator, device) if cfg.mtp_depth else None

    def all_layers(self) -> list[Layer]:
        """Every layer in ``cfg.layer_specs()`` order."""
        return list(self.prefix) + list(self.blocks)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self, tokens, self.cfg, positions)[0]


def _embedding(shape, cfg: ModelConfig, gen, device) -> nn.Parameter:
    """(N(0, 1) * 0.02) in float32, then cast to the parameter dtype."""
    if gen is None:
        return layers._param(torch.empty(shape, dtype=cfg.pdtype,
                                         device=device))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return layers._param((x * layers.INIT_SCALE).to(cfg.pdtype))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: _device.DeviceLike = None) -> Model:
    """Random weights from ``generator`` (default: seed 0), on the GPU
    unless ``device`` says otherwise.  The reference's initialisation
    (``repro.models.model.init_params``) from torch's random stream: the
    same distributions, not the same numbers."""
    dev = _device.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return Model(cfg, generator, dev)


# ============================================================== forward
def _run_body(params: Model, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, caches: Optional[list]
              ) -> tuple[torch.Tensor, Optional[list], torch.Tensor]:
    """Every layer in order -> (x, new caches or None, the layers' summed
    aux loss)."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.all_layers()):
        x, c, aux = layer(x, cfg, positions,
                          None if caches is None else caches[i])
        new_caches.append(c)
        if aux is not None:
            aux_total = aux_total + aux
    return x, (None if caches is None else new_caches), aux_total


def _embed(params: Model, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    return params.embed[tokens.long()].to(cfg.cdtype)


def _check_precision(cfg: ModelConfig, dev: torch.device) -> None:
    if cfg.cdtype == torch.float32:
        _device.check_full_fp32(dev, f"{cfg.name} at float32")


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), aux loss): the MoE
    layers' load-balancing losses summed, 0 without MoE layers."""
    _check_precision(cfg, tokens.device)
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = layers.positions_like(tokens)
    x, _, aux = _run_body(params, x, cfg, positions, None)
    h = layers.apply_norm(params.final_norm, x, cfg)
    return _project_logits(params, h, cfg), aux


def loss_fn(*args, **kwargs):
    """Training's loss (next-token CE, MoE aux, MTP): not ported yet."""
    raise NotImplementedError(f"loss_fn: {TRAIN_ITEM}")


def _project_logits(params: Model, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.cdtype
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(ct).T
    else:
        logits = x @ params.lm_head.to(ct)
    if cfg.logit_softcap > 0:
        lf = logits.to(torch.float32)
        logits = cfg.logit_softcap * torch.tanh(
            lf / floatops.const(cfg.logit_softcap, lf))
    return logits


# ============================================================== decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: _device.DeviceLike = None) -> dict:
    """{"layers": one {"attn": ...} per layer in ``cfg.layer_specs()``
    order, "step": 0-d int32}, in the compute dtype.  GQA: {"k", "v"}
    (B, T, KV, Dh), T = max_len, or the window when that is shorter (a
    ring buffer); MLA: the latent {"ckv" (B, max_len, kv_lora_rank),
    "k_rope" (B, max_len, 1, qk_rope_dim)}; each with "len" 0-d int32."""
    check_supported(cfg)
    dev = _device.resolve(device)
    t = min(max_len, cfg.window) if cfg.window else max_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.cdtype, device=dev)

    def one(spec: LayerSpec) -> dict:
        if cfg.attn_kind == "mla":
            c = {"ckv": zeros(batch, max_len, cfg.kv_lora_rank),
                 "k_rope": zeros(batch, max_len, 1, cfg.qk_rope_dim)}
        else:
            c = {"k": zeros(batch, t, cfg.n_kv, cfg.d_head),
                 "v": zeros(batch, t, cfg.n_kv, cfg.d_head)}
        c["len"] = torch.zeros((), dtype=torch.int32, device=dev)
        return {"attn": c}

    return {"layers": [one(s) for s in cfg.layer_specs()],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: Model, token: torch.Tensor, caches: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. token (B, 1) int32 -> (logits (B, 1, V), new
    caches); ``caches`` itself is left as it was."""
    _check_precision(cfg, token.device)
    x = _embed(params, token, cfg)
    positions = caches["step"].expand(token.shape[0], 1).to(torch.int32)
    x, new_layers, _ = _run_body(params, x, cfg, positions,
                                 caches["layers"])
    x = layers.apply_norm(params.final_norm, x, cfg)
    logits = _project_logits(params, x, cfg)
    return logits, {"layers": new_layers, "step": caches["step"] + 1}


def prefill(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, dict, None]:
    """Run the prompt through the decoder step by step to build a cache,
    as the reference does -> (logits (B, S, V), caches, None: the encoder
    output of an encoder-decoder model, which is not ported yet)."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_len, tokens.device)
    all_logits = []
    for t in range(s):
        logits, caches = decode_step(params, tokens[:, t:t + 1], caches, cfg)
        all_logits.append(logits[:, 0])
    return torch.stack(all_logits, 1), caches, None
