"""Model assembly, the port of ``repro.models.model``: embeddings, the
layer stack (GQA or MLA attention, or Mamba; dense or MoE MLPs;
cross-attention in an encoder-decoder's decoder), the encoder, logits,
the training loss (``loss_fn``: next-token cross-entropy, the MoE aux
loss and deepseek-v3's multi-token prediction), the decode cache,
``decode_step`` and ``prefill``.

The reference stacks the periodic body's parameters over periods and runs
it under ``lax.scan``, a compile-time idiom of XLA.  Here the body is an
``nn.ModuleList`` unrolled in ``cfg.layer_specs()`` order and a Python
loop runs it; ``convert`` carries the stacked tree across.  Decode caches
follow the same unrolled layout: a list with one entry per layer.  The
encoder's layers (``enc_blocks``) are unrolled the same way.

``loss_fn`` runs the layers with the parameters' gradients on (training
sets ``requires_grad``; serving leaves it off).  ``remat=True``
leaves the prefix layers plain and checkpoints each period of the body
as one unit (``torch.utils.checkpoint``, non-reentrant), as the
reference checkpoints its scanned period body: the backward recomputes a
period's activations instead of keeping them.  deepseek-v3's
multi-token-prediction head (``Model.mtp``) runs only in the loss, as in
the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from .. import device as _device
from ..core import floatops
from . import layers, moe, sharding, ssm
from .config import LayerSpec, ModelConfig


class Layer(nn.Module):
    """One layer of ``spec``: ``ln1`` and ``attn`` (GQA, or MLA when
    ``cfg.attn_kind`` is "mla") or ``mamba`` for a Mamba spec; ``ln_x``
    and ``xattn`` for a cross-attention spec; then ``ln2`` and ``moe`` for
    a MoE spec, or ``ln2`` and ``mlp`` of width ``d_ff`` when cfg.d_ff >
    0."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, d_ff: int,
                 generator=None, device=None):
        super().__init__()
        self.spec = spec
        self.ln1 = layers.init_norm(cfg, cfg.d_model, device)
        if spec.kind == "mamba":
            self.mamba = ssm.init_mamba(cfg, generator, device)
        else:
            self.attn = layers.init_attention(cfg, generator, device)
        if spec.cross_attn:
            self.ln_x = layers.init_norm(cfg, cfg.d_model, device)
            self.xattn = layers.init_attention(cfg, generator, device)
        if spec.moe:
            self.ln2 = layers.init_norm(cfg, cfg.d_model, device)
            self.moe = moe.init_moe(cfg, generator, device)
        elif cfg.d_ff > 0:
            self.ln2 = layers.init_norm(cfg, cfg.d_model, device)
            self.mlp = layers.init_mlp(cfg, d_ff, generator, device)

    def forward(self, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True
                ) -> tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
        """The reference's ``_apply_layer`` -> (x, new cache or None, the
        MoE aux loss 0-d float32 or, without MoE, None: the reference's
        zero).  ``enc_out`` is what a cross-attention layer attends to
        without a cache; ``causal`` False runs the self-attention
        unmasked (the encoder)."""
        aux = None
        new_cache = {}
        h = layers.apply_norm(self.ln1, x, cfg)
        if self.spec.kind == "mamba":
            out, c = ssm.mamba_forward(self.mamba, h, cfg,
                                       None if cache is None
                                       else cache["mamba"])
            new_cache["mamba"] = c
        else:
            attend = (layers.mla_attention if cfg.attn_kind == "mla"
                      else layers.attention)
            out, c = attend(self.attn, h, cfg if causal else _noncausal(cfg),
                            positions, None if cache is None
                            else cache["attn"])
            new_cache["attn"] = c
        x = x + out
        if self.spec.cross_attn:
            hx = layers.apply_norm(self.ln_x, x, cfg)
            xout, new_cache["xattn"] = layers.attention(
                self.xattn, hx, cfg, positions,
                None if cache is None else cache.get("xattn"),
                kv_src=enc_out, is_cross=True)
            x = x + xout
        if self.spec.moe:
            h2 = layers.apply_norm(self.ln2, x, cfg)
            mout, aux = moe.moe_layer(self.moe, h2, cfg)
            x = x + mout
        elif cfg.d_ff > 0:
            h2 = layers.apply_norm(self.ln2, x, cfg)
            x = x + layers.mlp(self.mlp, h2, cfg)
        return x, (None if cache is None else new_cache), aux


@functools.lru_cache(maxsize=None)
def _noncausal(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, causal=False)


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
    ``cfg.ff_dense``), ``blocks`` (the periodic body, unrolled), ``mtp``
    when ``cfg.mtp_depth``, and for an encoder-decoder ``enc_in_proj``
    (d, d), ``enc_blocks`` (``n_enc_layers`` dense attention layers) and
    ``enc_final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = layers._scaled_f32_init((cfg.vocab, d), cfg, generator,
                                             device)
        self.final_norm = layers.init_norm(cfg, d, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers._scaled_f32_init((d, cfg.vocab), cfg,
                                                generator, device))
        self.prefix = nn.ModuleList(
            Layer(spec, cfg, cfg.ff_dense, generator, device)
            for spec in cfg.prefix)
        self.blocks = nn.ModuleList(
            Layer(spec, cfg, cfg.d_ff, generator, device)
            for spec in cfg.period * cfg.n_periods)
        self.mtp = MTP(cfg, generator, device) if cfg.mtp_depth else None
        if cfg.enc_dec:
            self.enc_blocks = nn.ModuleList(
                Layer(LayerSpec(), cfg, cfg.d_ff, generator, device)
                for _ in range(cfg.n_enc_layers))
            self.enc_final_norm = layers.init_norm(cfg, d, device)
            self.enc_in_proj = layers._scaled_f32_init((d, d), cfg,
                                                       generator, device)

    def all_layers(self) -> list[Layer]:
        """Every layer in ``cfg.layer_specs()`` order."""
        return list(self.prefix) + list(self.blocks)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                enc_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self, tokens, self.cfg, positions, enc_frames)[0]


def reference_path(name: str, cfg: ModelConfig) -> tuple[tuple, int, int]:
    """The port's parameter name -> (the path of the reference's leaf that
    holds it, dict keys and list indices; its index along that leaf's
    stacked axis; the stacked axis' size, 0 for a leaf that is not
    stacked).  Layer i of the periodic body is row i // len(cfg.period)
    of the reference's ``blocks[i % len(cfg.period)]``; encoder layer i
    row i of ``enc_blocks``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, period = int(parts[1]), len(cfg.period)
        return (("blocks", i % period) + tuple(parts[2:]), i // period,
                cfg.n_periods)
    if parts[0] == "enc_blocks":
        return (("enc_blocks",) + tuple(parts[2:]), int(parts[1]),
                cfg.n_enc_layers)
    return tuple(int(x) if x.isdigit() else x for x in parts), 0, 0


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
              positions: torch.Tensor, caches: Optional[list],
              enc_out: Optional[torch.Tensor] = None, remat: bool = False
              ) -> tuple[torch.Tensor, Optional[list], torch.Tensor]:
    """Every layer in order -> (x, new caches or None, the layers' summed
    aux loss).  The prefix layers run plainly; the body runs one period
    (the ``len(cfg.period)`` layers of one step of the reference's scan)
    at a time, and ``remat`` (full sequence only) checkpoints each period
    as one unit, where the reference checkpoints its scanned body."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    every = params.all_layers()
    n_prefix, period = len(cfg.prefix), len(cfg.period)
    for i in range(n_prefix):
        x, c, aux = every[i](x, cfg, positions,
                             None if caches is None else caches[i], enc_out)
        new_caches.append(c)
        if aux is not None:
            aux_total = aux_total + aux
    for start in range(n_prefix, len(every), period):
        unit = every[start:start + period]
        if remat:
            x, cs, auxs = _checkpoint.checkpoint(
                _run_period, unit, x, cfg, positions, None, enc_out,
                use_reentrant=False, context_fn=_record_once)
        else:
            x, cs, auxs = _run_period(
                unit, x, cfg, positions,
                None if caches is None else caches[start:start + period],
                enc_out)
        new_caches.extend(cs)
        for aux in auxs:
            if aux is not None:
                aux_total = aux_total + aux
    return x, (None if caches is None else new_caches), aux_total


def _run_period(unit: list, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, caches: Optional[list],
                enc_out: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, list, list]:
    """One period of the body -> (x, each layer's new cache or None, each
    layer's aux or None).  The token stream passes through
    ``sharding.constrain_tokens`` where the reference's scanned period
    body starts and ends."""
    x = sharding.constrain_tokens(x)
    cs, auxs = [], []
    for k, layer in enumerate(unit):
        x, c, aux = layer(x, cfg, positions,
                          None if caches is None else caches[k], enc_out)
        cs.append(c)
        auxs.append(aux)
    return sharding.constrain_tokens(x), cs, auxs


@contextlib.contextmanager
def _not_recording(aux_parts: bool):
    with moe.not_recording(aux_parts), sharding.not_recording():
        yield


def _record_once():
    """A checkpointed period's contexts: its forward as it is, its
    recomputation in the backward without MoE routing, aux-part or
    activation-constraint records (the forward recorded them once
    already), computing the aux parts where the forward did."""
    return contextlib.nullcontext(), _not_recording(moe.in_aux_parts())


def encode(params: Model, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder of an encoder-decoder model.  frames (B, S_enc, d) from
    the modality frontend's stub -> (B, S_enc, d) after
    ``enc_final_norm``: ``enc_in_proj``, sinusoidal positions, then the
    ``enc_blocks`` (causal only when ``cfg.enc_causal``)."""
    ct = cfg.cdtype
    x = frames.to(ct) @ params.enc_in_proj.to(ct)
    pos = layers.positions_like(frames[..., 0])
    x = x + layers._sinusoidal(frames.shape[1], cfg.d_model,
                               frames.device).to(ct)[None]
    for layer in params.enc_blocks:
        x, _, _ = layer(x, cfg, pos, causal=cfg.enc_causal)
    return layers.apply_norm(params.enc_final_norm, x, cfg)


def _embed(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype, plus the sinusoidal ones of
    ``positions`` where ``cfg.pos_embed`` says so."""
    x = params.embed[tokens.long()].to(cfg.cdtype)
    if cfg.pos_embed == "sinusoidal":
        x = x + layers._sinusoidal_at(positions, cfg.d_model).to(cfg.cdtype)
    return x


def _check_precision(cfg: ModelConfig, dev: torch.device) -> None:
    if cfg.cdtype == torch.float32:
        _device.check_full_fp32(dev, f"{cfg.name} at float32")


def _forward_hidden(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
                    positions: Optional[torch.Tensor],
                    enc_frames: Optional[torch.Tensor], remat: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The trunk -> (hidden states after ``final_norm`` (B, S, d), aux
    loss)."""
    _check_precision(cfg, tokens.device)
    if positions is None:
        positions = layers.positions_like(tokens)
    x = sharding.constrain_tokens(_embed(params, tokens, cfg, positions))
    enc_out = None
    if cfg.enc_dec:
        assert enc_frames is not None, "enc-dec model needs encoder frames"
        enc_out = encode(params, enc_frames, cfg)
    x, _, aux = _run_body(params, x, cfg, positions, None, enc_out, remat)
    return layers.apply_norm(params.final_norm, x, cfg), aux


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), aux loss): the MoE
    layers' load-balancing losses summed, 0 without MoE layers.  An
    encoder-decoder model needs its encoder's ``enc_frames``."""
    h, aux = _forward_hidden(params, tokens, cfg, positions, enc_frames)
    return _project_logits(params, h, cfg), aux


def loss_fn(params: Model, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, enc_frames: Optional[torch.Tensor] = None,
            remat: bool = True, positions: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy + 0.01 x the MoE aux loss (+ 0.3 x the
    depth-1 MTP loss when ``cfg.mtp_depth``) -> (total 0-d float32,
    {"ce", "aux"[, "mtp"], "loss"}): ``loss_from_parts`` of this batch's
    ``loss_parts``.  Labels < 0 are masked out."""
    return loss_from_parts([loss_parts(params, tokens, labels, cfg,
                                       enc_frames, remat, positions)], cfg)


def loss_parts(params: Model, tokens: torch.Tensor, labels: torch.Tensor,
               cfg: ModelConfig, enc_frames: Optional[torch.Tensor] = None,
               remat: bool = True, positions: Optional[torch.Tensor] = None
               ) -> dict:
    """The loss's sums over this batch, which ``loss_from_parts`` adds over
    the batch shards of a sharded step before it divides: {"ce": (the
    labelled positions' summed log-likelihood, their count), "mtp": the
    same for the MTP head (when ``cfg.mtp_depth``), "moe": each MoE
    layer's (2, E) sums (``moe.aux_parts``), "tokens": B x S}."""
    with moe.aux_parts() as moe_parts:
        h, _ = _forward_hidden(params, tokens, cfg, positions, enc_frames,
                               remat)
    out = {"ce": _xent_sums(_project_logits(params, h, cfg), labels),
           "moe": moe_parts, "tokens": tokens.numel()}
    if cfg.mtp_depth:
        out["mtp"] = _mtp_sums(params, h, tokens, labels, cfg)
    return out


def loss_from_parts(parts: list[dict], cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """``loss_fn``'s (total, metrics) from the ``loss_parts`` of each batch
    shard (one for a whole batch), on the first shard's device: every sum
    is added over the shards in their order, and each mean and the MoE
    aux loss (a product of two means over every token) are taken once,
    over the whole batch.  XLA contracts each weighted add into one
    multiply-add (``addcmul``)."""
    dev = parts[0]["ce"][0].device

    def added(key: str, k: int) -> torch.Tensor:
        total = parts[0][key][k]
        for p in parts[1:]:
            total = total + p[key][k].to(dev)
        return total

    ce = _mean(added("ce", 0), added("ce", 1))
    tokens = sum(p["tokens"] for p in parts)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for layer in range(len(parts[0]["moe"])):
        aux = aux + moe.aux_from_parts([p["moe"][layer] for p in parts],
                                       tokens, cfg)
    total = torch.addcmul(ce, floatops.const(0.01, ce), aux)
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        mtp = _mean(added("mtp", 0), added("mtp", 1))
        total = torch.addcmul(total, floatops.const(0.3, mtp), mtp)
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


def _xent_sums(logits: torch.Tensor, labels: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 cross-entropy's sums over the positions with a label >= 0:
    (the summed log-likelihood, the count)."""
    mask = labels >= 0
    labs = torch.clamp_min(labels, 0).long()
    lp = torch.log_softmax(logits.to(torch.float32), -1)
    ll = torch.gather(lp, -1, labs[..., None])[..., 0]
    return (ll * mask).sum(), mask.sum()


def _mean(ll_sum: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy from ``_xent_sums``."""
    return -ll_sum / torch.clamp_min(count, 1).to(torch.float32)


def _mtp_sums(params: Model, h: torch.Tensor, tokens: torch.Tensor,
              labels: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's depth-1 multi-token prediction: the trunk's hidden
    state at t joined with the embedding of token t+1, one extra dense
    layer and ``norm``, predicting label t+1 (token t+2); its
    ``_xent_sums``."""
    ct = cfg.cdtype
    mtp = params.mtp
    x = params.embed[tokens.long()].to(ct)
    positions = layers.positions_like(tokens)
    nxt_emb = torch.roll(x, -1, 1)
    comb = torch.cat([h, nxt_emb], -1) @ mtp.proj.to(ct)
    comb, _, _ = mtp.block(comb, cfg, positions)
    comb = layers.apply_norm(mtp.norm, comb, cfg)
    logits = _project_logits(params, comb, cfg)
    mtp_labels = torch.roll(labels, -1, 1)
    mtp_labels[:, -1] = -1
    return _xent_sums(logits, mtp_labels)


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
               device: _device.DeviceLike = None, enc_len: int = 0) -> dict:
    """{"layers": one entry per layer in ``cfg.layer_specs()`` order,
    "step": 0-d int32}, in the compute dtype.  An attention layer's
    {"attn": ...}: GQA's {"k", "v"} (B, T, KV, Dh), T = max_len, or the
    window when that is shorter (a ring buffer); MLA's latent {"ckv" (B,
    max_len, kv_lora_rank), "k_rope" (B, max_len, 1, qk_rope_dim)}; each
    with "len" 0-d int32.  A Mamba layer's {"mamba": {"conv", "h"}}
    (``ssm.init_mamba_cache``).  A cross-attention layer adds {"xattn":
    {"k", "v"} (B, enc_len, KV, Dh)}, which ``fill_cross_caches``
    fills."""
    dev = _device.resolve(device)
    t = min(max_len, cfg.window) if cfg.window else max_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.cdtype, device=dev)

    def one(spec: LayerSpec) -> dict:
        if spec.kind == "mamba":
            out = {"mamba": ssm.init_mamba_cache(cfg, batch, cfg.cdtype,
                                                 dev)}
        else:
            if cfg.attn_kind == "mla":
                c = {"ckv": zeros(batch, max_len, cfg.kv_lora_rank),
                     "k_rope": zeros(batch, max_len, 1, cfg.qk_rope_dim)}
            else:
                c = {"k": zeros(batch, t, cfg.n_kv, cfg.d_head),
                     "v": zeros(batch, t, cfg.n_kv, cfg.d_head)}
            c["len"] = torch.zeros((), dtype=torch.int32, device=dev)
            out = {"attn": c}
        if spec.cross_attn:
            out["xattn"] = {"k": zeros(batch, enc_len, cfg.n_kv, cfg.d_head),
                            "v": zeros(batch, enc_len, cfg.n_kv, cfg.d_head)}
        return out

    return {"layers": [one(s) for s in cfg.layer_specs()],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def fill_cross_caches(params: Model, caches: dict, enc_out: torch.Tensor,
                      cfg: ModelConfig) -> dict:
    """The cross-attention layers' keys and values of ``enc_out`` written
    into ``caches`` (in place, and returned)."""
    ct = cfg.cdtype
    enc = enc_out.to(ct)
    for layer, c in zip(params.all_layers(), caches["layers"]):
        if layer.spec.cross_attn:
            c["xattn"] = {
                "k": torch.einsum("btd,dhk->bthk", enc, layer.xattn.wk.to(ct)),
                "v": torch.einsum("btd,dhk->bthk", enc,
                                  layer.xattn.wv.to(ct))}
    return caches


def decode_step(params: Model, token: torch.Tensor, caches: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. token (B, 1) int32 -> (logits (B, 1, V), new
    caches); ``caches`` itself is left as it was.  Cross-attention reads
    its keys and values from the cache (``fill_cross_caches``)."""
    _check_precision(cfg, token.device)
    positions = caches["step"].expand(token.shape[0], 1).to(torch.int32)
    x = _embed(params, token, cfg, positions)
    x, new_layers, _ = _run_body(params, x, cfg, positions,
                                 caches["layers"])
    x = layers.apply_norm(params.final_norm, x, cfg)
    logits = _project_logits(params, x, cfg)
    return logits, {"layers": new_layers, "step": caches["step"] + 1}


def prefill(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, enc_frames: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    """Run the prompt through the decoder step by step to build a cache,
    as the reference does -> (logits (B, S, V), caches, the encoder's
    output of ``enc_frames`` for an encoder-decoder model, else None)."""
    b, s = tokens.shape
    enc_out = encode(params, enc_frames, cfg) if cfg.enc_dec else None
    caches = init_cache(cfg, b, max_len, tokens.device,
                        enc_len=0 if enc_frames is None
                        else enc_frames.shape[1])
    if enc_out is not None:
        caches = fill_cross_caches(params, caches, enc_out, cfg)
    all_logits = []
    for t in range(s):
        logits, caches = decode_step(params, tokens[:, t:t + 1], caches, cfg)
        all_logits.append(logits[:, 0])
    return torch.stack(all_logits, 1), caches, enc_out
