"""AdamW with a cosine schedule and global-norm clipping, the PyTorch port
of ``repro.optim.adamw``.

Functions over a model's named parameters (an ``nn.Module``): the moments
are float32 dicts keyed by parameter name, whatever the parameter dtype,
and ``adamw_update`` writes the new parameters and moments in place, under
``torch.no_grad`` (the reference returns new trees; its trainer donates
the old ones).  ``torch.optim.AdamW`` is not used: its decay and clipping
differ from the reference's.

The reference's numbers, which the update reproduces:

- **Decay by the reference leaf's rank.**  The reference decays a leaf
  when ``p.ndim >= 2``.  It stacks the periodic body (``blocks``) and the
  encoder (``enc_blocks``) over a leading axis, so a norm scale, ``q_norm``
  / ``kv_norm`` or a Mamba ``A_log`` / ``D`` / ``dt_bias`` / ``conv_b`` /
  ``norm_scale`` inside them is 2-D there and decays, while the same
  vector in ``prefix``, ``mtp`` or ``final_norm`` is 1-D and does not.
  The port's layers are unrolled, so ``reference_leaves`` gives each
  parameter its reference leaf and the rule reads that leaf's rank.
- **The global norm** sums each reference leaf's squares (a stacked leaf
  over all its periods) and adds the leaves in ``jax.tree.leaves`` order.
  Within a leaf the order is PyTorch's, not XLA's: the norm is ulp-close.
- **float32 constants.**  ``1 - b1`` and the other Python constants are
  rounded to float32 as JAX rounds them (``floatops.const``), and
  ``b1 ** step`` is a float32 power (``floatops.powf``).
- **XLA's fused expression.**  Inside the reference's jitted step XLA
  contracts ``b1 * m + (1 - b1) * g`` into ``fma(b1, m, (1 - b1) * g)``
  (and the same for ``nu``), the decay into ``fma(wd, p, delta)`` and the
  step into ``fma(-lr, delta, p)``, each rounded once
  (``torch.addcmul``), and rewrites ``(m / c1) / (sqrt(vhat) + eps)`` as
  ``m / (c1 * (sqrt(vhat) + eps))``.  With the same clip scale the update
  is bitwise the reference's jitted one; the scale follows the global
  norm, which is ulp-close.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..analysis import ops
from ..core import floatops
from ..models import model


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    mu: dict               # parameter name -> float32 first moment
    nu: dict               # parameter name -> float32 second moment
    step: torch.Tensor     # 0-d int32


def reference_leaves(params: nn.Module) -> list[tuple[tuple, int, list]]:
    """The reference's parameter leaves in ``jax.tree.leaves`` order: (its
    path, its stacked axis' size or 0, the port's parameter names that
    make it up in stacking order); ``model.reference_path`` places each
    name."""
    groups: dict[tuple, list] = {}
    stacks: dict[tuple, int] = {}
    for name, _ in params.named_parameters():
        path, row, stack = model.reference_path(name, params.cfg)
        groups.setdefault(path, []).append((row, name))
        stacks[path] = stack
    return [(path, stacks[path], [n for _, n in sorted(groups[path])])
            for path in sorted(groups)]


def decays(params: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether the reference decays its leaf (the leaf,
    stacked or not, has rank >= 2)."""
    named = dict(params.named_parameters())
    return {name: named[name].dim() + bool(stack) >= 2
            for _, stack, names in reference_leaves(params)
            for name in names}


def adamw_init(params: nn.Module) -> AdamWState:
    zeros = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for name, p in params.named_parameters()}
    dev = next(iter(zeros.values())).device
    return AdamWState(mu=zeros,
                      nu={k: torch.zeros_like(v) for k, v in zeros.items()},
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate (0-d float32) at ``step`` (0-d int32): linear
    warm-up, then a cosine down to ``min_lr_ratio`` of ``cfg.lr``.  XLA
    multiplies by the float32 reciprocal of a constant divisor, and its
    float32 ``cos`` is correctly rounded (taken here in float64)."""
    s = step.to(torch.float32)
    c = lambda v: floatops.const(v, s)  # noqa: E731
    warm = torch.clamp(s * c(_recip(cfg.warmup_steps)), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                    * c(_recip(cfg.total_steps - cfg.warmup_steps)),
                    0.0, 1.0)
    cos = c(0.5) * (c(1.0) + torch.cos((c(math.pi) * t).double()).float())
    frac = torch.addcmul(c(cfg.min_lr_ratio), c(1 - cfg.min_lr_ratio), cos)
    return c(cfg.lr) * warm * frac


def _recip(n: int) -> float:
    """float32 ``1 / max(n, 1)``."""
    return float(np.float32(1.0) / np.float32(max(n, 1)))


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return torch.sum(xf * xf)


def global_norm(grads: dict, params: nn.Module) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, the reference leaves
    added in its order (``grads``: parameter name -> gradient)."""
    total = None
    for _, _, names in reference_leaves(params):
        leaf = _sum_squares(grads[names[0]])
        for name in names[1:]:
            leaf = leaf + _sum_squares(grads[name])
        total = leaf if total is None else total + leaf
    return _sqrt(total)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # the card's float32 sqrt is correctly rounded; the CPU's is not (a
    # ``meta`` trace takes the card's path)
    return floatops.sqrt(x) if x.device.type == "cpu" else torch.sqrt(x)


def _pow(base: float, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    return floatops.powf(floatops.const(base, s), s)


def _constants(cfg: AdamWConfig, step: torch.Tensor,
               gnorm: torch.Tensor) -> dict:
    """The update's 0-d float32 factors at ``step`` (already advanced)
    for the global norm ``gnorm``: the clip scale, the learning rate and
    Adam's constants."""
    c = lambda v: floatops.const(v, gnorm)  # noqa: E731
    lr = cosine_lr(cfg, step)
    return {"scale": torch.clamp(c(cfg.clip_norm)
                                 / torch.clamp_min(gnorm, 1e-9), max=1.0),
            "lr": lr, "neg_lr": -lr,
            "c1": c(1.0) - _pow(cfg.b1, step),
            "c2": c(1.0) - _pow(cfg.b2, step),
            "b1": c(cfg.b1), "b2": c(cfg.b2), "one_b1": c(1 - cfg.b1),
            "one_b2": c(1 - cfg.b2), "eps": c(cfg.eps),
            "wd": c(cfg.weight_decay)}


def _apply(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, decay: bool, k: dict) -> None:
    """One parameter's update in place (elementwise: a slice's update is
    the slice of the whole's)."""
    g = g.to(torch.float32) * k["scale"]
    m = torch.addcmul(k["one_b1"] * g, k["b1"], mu)
    v = torch.addcmul((k["one_b2"] * g) * g, k["b2"], nu)
    delta = m / (k["c1"] * (_sqrt(v / k["c2"]) + k["eps"]))
    pf = p.to(torch.float32)
    if decay:
        delta = torch.addcmul(delta, k["wd"], pf)
    p.copy_(torch.addcmul(pf, k["neg_lr"], delta))
    mu.copy_(m)
    nu.copy_(v)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: nn.Module) -> tuple[nn.Module, AdamWState, dict]:
    """One AdamW step over ``params`` from ``grads`` (parameter name ->
    gradient, any float dtype): the parameters and moments are written in
    place -> (params, the new state, {"grad_norm", "lr"} 0-d float32)."""
    step = state.step + 1
    gnorm = global_norm(grads, params)
    k = _constants(cfg, step, gnorm)
    decay = decays(params)
    for name, p in params.named_parameters():
        _apply(p, grads[name], state.mu[name], state.nu[name], decay[name],
               k)
    return params, AdamWState(state.mu, state.nu, step), {
        "grad_norm": gnorm, "lr": k["lr"]}


# ------------------------------------------------------------- sharded
# The same optimizer over a ``models.sharded.ShardedModel``: the moments
# are held in the parameters' shards (``mu[name]``, ``nu[name]``: one
# float32 tensor per mesh position), the step count on the first
# position's device.


def adamw_init_sharded(params) -> AdamWState:
    """Zero moments in ``params``' shards."""
    def zeros():
        return {name: [torch.zeros(s.shape, dtype=torch.float32,
                                   device=s.device) for s in shards]
                for name, shards in params.shards.items()}
    return AdamWState(mu=zeros(), nu=zeros(), step=torch.zeros(
        (), dtype=torch.int32, device=params.root))


def global_norm_sharded(grads: dict, params) -> torch.Tensor:
    """``global_norm`` of gradients held in shards (``grads[name]``: one
    per position): each parameter's squares summed over its distinct
    shards in position order, a replicated slice once; on the first
    position's device."""
    root = params.root

    def squares(name: str) -> torch.Tensor:
        total = None
        for pos in params.shardings[name].distinct():
            if grads[name][pos] is None:      # not run (``ops.runs``)
                continue
            sq = _sum_squares(grads[name][pos]).to(root)
            total = sq if total is None else total + sq
        return total

    total = None
    for _, _, names in reference_leaves(params.meta):
        leaf = None
        for name in names:
            sq = squares(name)
            if sq is not None:            # None: not run (``ops.runs``)
                leaf = sq if leaf is None else leaf + sq
        if leaf is not None:
            total = leaf if total is None else total + leaf
    return _sqrt(total)


@torch.no_grad()
def adamw_update_sharded(cfg: AdamWConfig, grads: dict, state: AdamWState,
                         params) -> tuple[object, AdamWState, dict]:
    """``adamw_update`` on every position's shard, from the gradients'
    shards; the norm is the whole gradient's (``global_norm_sharded``).
    A position with no gradient for a parameter (it holds an empty shard
    of it) leaves that shard as it is."""
    step = state.step + 1
    gnorm = global_norm_sharded(grads, params)
    k = _constants(cfg, step, gnorm)
    on: dict = {}
    decay = decays(params.meta)
    for name, shards in params.shards.items():
        for pos, p in enumerate(shards):
            if grads[name][pos] is None:
                continue
            kd = on.get(p.device)
            if kd is None:
                kd = on[p.device] = {key: v.to(p.device)
                                     for key, v in k.items()}
            with ops.at_position(pos):
                _apply(p, grads[name][pos], state.mu[name][pos],
                       state.nu[name][pos], decay[name], kd)
    return params, AdamWState(state.mu, state.nu, step), {
        "grad_norm": gnorm, "lr": k["lr"]}
