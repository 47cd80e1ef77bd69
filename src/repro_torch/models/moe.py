"""Mixture-of-Experts layer with capacity-based sort dispatch, the PyTorch
port of ``repro.models.moe``.

Dispatch is the reference's production formulation, grouped per sequence:
route each token to its top-k experts, stable-sort the (token, k) pairs by
expert, give each pair its slot in its expert's group, drop the pairs past
the capacity, gather an (E, C, d) expert batch, run every expert as one
batched product and combine the weighted outputs.  Index gathers do the
dispatch; no one-hot matrix is built.

The combine is the reference's scatter-add in the sorted order, in the
compute dtype: each token receives its pairs in ascending expert order,
so the port sums each token's k contributions in that order, one rounded
add after another.  Written as a gather and k adds it is the same sum on
the CPU and on the card, where ``index_add_`` would add in atomic order.

Shared experts (deepseek-v3) run densely on every token.  The router
computes float32 logits whatever the parameter dtype, renormalises the
top-k gates and returns the Switch load-balancing loss (returned, not
applied).  The expert batch passes through the reference's constraint,
``sharding.constrain_expert_batch``, before and after the expert products.

The loss is a product of two means over every token of the batch.  Where
the batch is split into shards (the sharded train step), ``aux_parts``
collects each call's sums instead, ``aux_from_parts`` adds them over the
shards and takes the product once.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
from torch import nn

from ..core import floatops
from . import layers, sharding
from .config import ModelConfig

# While ``recording()`` is active in this context: one (probs (B, S, E)
# float32, experts (B, S, K)) pair per ``moe_layer`` call, in call order
_RECORD: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "moe_routing_record", default=None)


@contextlib.contextmanager
def recording():
    """Record every ``moe_layer`` call's router probabilities and chosen
    experts into the list this yields (a check's view of the routing:
    where two runs route a token differently, and how close it was)."""
    record: list = []
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


# While ``aux_parts()`` is active: one (2, E) float32 tensor per
# ``moe_layer`` call (the router probabilities summed over the tokens, and
# the count of (token, k) pairs routed to each expert), in call order
_AUX_PARTS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "moe_aux_parts", default=None)


@contextlib.contextmanager
def not_recording(aux_parts: bool = False):
    """No routing and no aux parts are recorded inside (a checkpointed
    layer's recomputation in the backward repeats a routing its forward
    recorded).  With ``aux_parts`` ``moe_layer`` computes its aux parts
    and drops them, so that the recomputation of a forward that ran
    inside ``aux_parts()`` runs the same operations."""
    token = _RECORD.set(None)
    parts = _AUX_PARTS.set([] if aux_parts else None)
    try:
        yield
    finally:
        _AUX_PARTS.reset(parts)
        _RECORD.reset(token)


def in_aux_parts() -> bool:
    return _AUX_PARTS.get() is not None


@contextlib.contextmanager
def aux_parts():
    """Inside, ``moe_layer`` returns no aux loss and appends its sums to
    the list this yields instead (``aux_from_parts`` turns them into the
    loss)."""
    parts: list = []
    token = _AUX_PARTS.set(parts)
    try:
        yield parts
    finally:
        _AUX_PARTS.reset(token)


def aux_from_parts(shards: Sequence[torch.Tensor], tokens: int,
                   cfg: ModelConfig) -> torch.Tensor:
    """One layer's load-balancing loss from its (2, E) sums over the batch
    shards (``aux_parts``, each shard's on its own device) and the
    batch's ``tokens``: the sums added over the shards in order, then
    ``E * sum(me * ce)`` as ``moe_layer`` computes it over a whole
    batch."""
    dev = shards[0].device
    total = shards[0]
    for part in shards[1:]:
        total = total + part.to(dev)
    me = total[0] / tokens
    ce = total[1] / (tokens * cfg.top_k)
    return cfg.n_experts * torch.sum(me * ce)


def _expert_init(shape, dtype, gen: Optional[torch.Generator],
                 device) -> nn.Parameter:
    """The reference's ``_norm_init`` (N(0, 1) in float32, cast, scaled in
    the dtype) drawn one expert (leading index) at a time, so that the
    float32 draw never holds more than one expert: deepseek-v3's (256,
    7168, 2048) tensor would be 15 GB of float32 at once."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if gen is not None:
        for i in range(shape[0]):
            x = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                            device=device)
            out[i] = x.to(dtype) * layers.INIT_SCALE
    return layers._param(out)


class MoE(nn.Module):
    """``router`` (d, E) float32, ``wi``/``wg`` (E, d, ff) and ``wo`` (E,
    ff, d) (``wg`` for swiglu), and with shared experts ``shared_wi``/
    ``shared_wg`` (d, ff * n_shared) and ``shared_wo``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.ff_expert, cfg.n_experts
        self.router = layers._normal_init((d, e), cfg, generator, device,
                                          dtype=torch.float32)
        self.wi = _expert_init((e, d, ff), cfg.pdtype, generator, device)
        if cfg.mlp_kind == "swiglu":
            self.wg = _expert_init((e, d, ff), cfg.pdtype, generator, device)
        self.wo = _expert_init((e, ff, d), cfg.pdtype, generator, device)
        if cfg.n_shared_experts:
            sff = ff * cfg.n_shared_experts
            self.shared_wi = layers._normal_init((d, sff), cfg, generator,
                                                 device)
            if cfg.mlp_kind == "swiglu":
                self.shared_wg = layers._normal_init((d, sff), cfg,
                                                     generator, device)
            self.shared_wo = layers._normal_init((sff, d), cfg, generator,
                                                 device)


def init_moe(cfg: ModelConfig, generator=None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def _expert_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d), batched over experts."""
    return _expert_ffn_batched(p, x[None], cfg)[0]


def _expert_ffn_batched(p: MoE, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """x (B, E, C, d) -> (B, E, C, d); experts broadcast over the batch."""
    ct = cfg.cdtype
    if cfg.mlp_kind == "swiglu":
        h = layers._act(torch.einsum("becd,edf->becf", x, p.wg.to(ct)),
                        cfg.act) * torch.einsum("becd,edf->becf", x,
                                                p.wi.to(ct))
    else:
        h = layers._act(torch.einsum("becd,edf->becf", x, p.wi.to(ct)),
                        cfg.act)
    return torch.einsum("becf,efd->becd", h, p.wo.to(ct))


def _shared(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.cdtype
    if cfg.mlp_kind == "swiglu":
        hsh = layers._act(xt @ p.shared_wg.to(ct), cfg.act) \
            * (xt @ p.shared_wi.to(ct))
    else:
        hsh = layers._act(xt @ p.shared_wi.to(ct), cfg.act)
    return hsh @ p.shared_wo.to(ct)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: MoE, xt: torch.Tensor, cfg: ModelConfig,
           generator: Optional[torch.Generator] = None):
    """float32 logits, softmax, top-k, gates renormalised by
    max(sum, 1e-9) -> (probs (..., E), gate (..., K) float32, experts
    (..., K) int64)."""
    logits = xt.to(torch.float32) @ p.router
    if cfg.router_noise > 0.0 and generator is not None:
        logits = logits + cfg.router_noise * torch.randn(
            logits.shape, generator=generator, dtype=torch.float32,
            device=logits.device)
    probs = torch.softmax(logits, -1)
    gate, idx = _top_k(probs, cfg.top_k)
    gate = gate / torch.clamp_min(floatops.xla_sum(gate), 1e-9)[..., None]
    return probs, gate, idx


def moe_layer(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              generator: Optional[torch.Generator] = None
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), aux loss 0-d float32, or None
    inside ``aux_parts``).

    Capacity is S*K/E*capacity_factor per sequence; ``generator`` draws
    the router noise when ``cfg.router_noise`` > 0."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ct = cfg.cdtype
    dev = x.device
    xt = x.to(ct)
    probs, gate, idx = _route(p, xt, cfg, generator)
    record = _RECORD.get()
    if record is not None:
        record.append((probs, idx))

    # load-balance auxiliary (Switch-style): E * sum_e f_e * P_e
    # counted by a scatter of ones (``bincount`` has no meta kernel)
    flat = idx.reshape(-1).long()
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32)
    parts = _AUX_PARTS.get()
    if parts is None:
        me = probs.mean((0, 1))
        aux = e * torch.sum(me * (counts / (b * s * k)))
    else:
        aux = None
        parts.append(torch.stack([probs.sum((0, 1)), counts]))

    cap = int(max(1, round(s * k / e * cfg.capacity_factor)))

    # Each token's pairs in ascending expert order: the stable sort by
    # expert orders a group by token either way, and the combine adds a
    # token's pairs in this order.
    idx, perm = torch.sort(idx, -1)
    gate = gate.gather(-1, perm)
    flat_e = idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    st = torch.div(order, k, rounding_mode="floor")   # token of each pair
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    grp_start = torch.searchsorted(se, experts)                    # (B, E)
    count = torch.searchsorted(se, experts, right=True) - grp_start
    rows = torch.arange(b, device=dev)[:, None]

    # dispatch: slot c of expert j holds the group's c-th pair, if any
    c = torch.arange(cap, device=dev)
    src = torch.clamp(grp_start[..., None] + c, max=s * k - 1)
    filled = (c < count[..., None]).reshape(b, e * cap, 1)
    tok = st.gather(1, src.reshape(b, e * cap))
    ebatch = sharding.constrain_expert_batch(
        torch.where(filled, xt[rows, tok], 0).reshape(b, e, cap, d))
    eout = sharding.constrain_expert_batch(
        _expert_ffn_batched(p, ebatch, cfg)).reshape(b, e * cap, d)

    # combine: each pair's slot back in (token, k) order
    slot_sorted = torch.arange(s * k, device=dev) - grp_start.gather(1, se)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = (slot < cap)[..., None]
    dst = flat_e * cap + torch.where(keep[..., 0], slot, 0)
    contrib = torch.where(keep, eout[rows, dst]
                          * gate.reshape(b, s * k, 1).to(ct), 0)
    contrib = contrib.reshape(b, s, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]

    if cfg.n_shared_experts:
        out = out + _shared(p, xt, cfg)
    return out, aux


def moe_layer_dense_eval(p: MoE, x: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every expert on every token, combined by the router's
    top-k gates (the reference's test oracle for the sparse dispatch)."""
    b, s, d = x.shape
    e = cfg.n_experts
    ct = cfg.cdtype
    xt = x.reshape(-1, d).to(ct)
    probs, gate, idx = _route(p, xt, cfg)
    mask = torch.zeros_like(probs).scatter_(1, idx, gate)
    every = _expert_ffn(p, xt.expand((e,) + tuple(xt.shape)), cfg)
    out = torch.einsum("te,etd->td", mask.to(ct), every)
    if cfg.n_shared_experts:
        out = out + _shared(p, xt, cfg)
    return out.reshape(b, s, d)
