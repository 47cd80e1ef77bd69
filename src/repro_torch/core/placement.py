"""The ACO engine applied to layer-to-pipeline-stage placement, the PyTorch
port of ``repro.core.placement``.

Problem: assign L heterogeneous layers (per-layer compute cost c_i,
inter-layer activation traffic t_i) to S stages.  Cost = max stage load
(the pipeline bottleneck) + lambda * the sum of cut traffic.  Contiguity
is not assumed, so the search space is S^L.  The colony keeps an (L, S)
pheromone matrix; all m ants pick a stage for layer i at once (an (m, S)
tensor op a step, the paper's data-parallel pattern) with the independent
roulette over the port's threefry draws, then evaporate and let the best
quartile deposit.

The reference's arithmetic is XLA's, and the port follows it where it
decides a bit:

- its one-hot ``einsum``s are sums of the selected terms, which XLA's CPU
  dot adds in index order up to 42 terms and in a vectorised order past
  that (``_onehot_sum`` over ``floatops.xla_dot_sum``; measured below 80
  terms, index order beyond, where a cost or a tau cell may be an ulp
  off);
- ``jnp.quantile(costs, 0.25)`` sorts and interpolates linearly between
  the two neighbouring order statistics (``_quantile``);
- ``(1 - rho) * tau + dep`` and ``bottleneck + lambda * comm`` are fused
  multiply-adds under jit (``torch.addcmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from . import floatops, sampling


@dataclasses.dataclass(frozen=True)
class PlacementProblem:
    """Hashable problem description; costs stored as tuples of floats."""
    layer_costs: tuple             # (L,) per-layer compute cost
    edge_traffic: tuple            # (L,) activation bytes out of layer i
    n_stages: int
    comm_lambda: float = 0.25      # traffic weight vs load balance

    def __post_init__(self):
        object.__setattr__(self, "layer_costs",
                           tuple(float(x) for x in self.layer_costs))
        object.__setattr__(self, "edge_traffic",
                           tuple(float(x) for x in self.edge_traffic))

    @property
    def n_layers(self) -> int:
        return len(self.layer_costs)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    ants: int = 64
    iterations: int = 60
    alpha: float = 1.0
    beta: float = 2.0
    rho: float = 0.3
    q: float = 1.0
    seed: int = 0


def _f32(values, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=dev)


def _onehot_sum(onehot: torch.Tensor, vals: torch.Tensor, dim: int,
                in_step: bool) -> torch.Tensor:
    """``sum_k onehot[.., k, ..] * vals[k]`` over axis ``dim`` of
    ``onehot``, the terms added in the order of XLA's CPU dot
    (``floatops.xla_dot_sum``; no matmul: a float32 product here could run
    in TF32 on the card, and a library matmul sums in blocks).
    ``in_step``: inside the reference's jitted step, whose fusions
    transpose the picks into the one-hot operand."""
    shape = [1] * onehot.dim()
    shape[dim] = -1
    terms = onehot * vals.reshape(shape)
    return floatops.xla_dot_sum(torch.movedim(terms, dim, -1),
                                2 if in_step else None)


def _cost(prob: PlacementProblem, assign: torch.Tensor,
          fused: bool) -> torch.Tensor:
    """``assignment_cost``; ``fused``: as inside the reference's jitted
    step (the last multiply-add rounded once, the loads summed in that
    step's order)."""
    dev = assign.device
    c = _f32(prob.layer_costs, dev)
    t = _f32(prob.edge_traffic, dev)
    onehot = torch.nn.functional.one_hot(
        assign.long(), prob.n_stages).to(torch.float32)    # (..., L, S)
    loads = _onehot_sum(onehot, c, onehot.dim() - 2, fused)  # (..., S)
    bottleneck = loads.amax(-1)
    cuts = (assign[..., 1:] != assign[..., :-1]).to(torch.float32)
    comm = floatops.xla_sum(cuts * t[:-1])
    lam = floatops.const(prob.comm_lambda, bottleneck)
    if fused:
        return torch.addcmul(bottleneck, lam, comm)
    return bottleneck + lam * comm


def assignment_cost(prob: PlacementProblem,
                    assign: torch.Tensor) -> torch.Tensor:
    """assign (..., L) int -> the cost of each assignment (float32)."""
    return _cost(prob, assign, fused=False)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (method 'linear') of a 1-D float32 tensor:
    the float32 position ``q * (n - 1)``, its floor and ceiling order
    statistics, weighted ``low * (1 - frac) + high * frac`` with the first
    product fused into the add (XLA's multiply-add)."""
    s = torch.sort(x).values
    pos = floatops.const(q, x) * floatops.const(x.shape[0] - 1, x)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_v = s[low.long()]
    hi_v = s[high.long()]
    return torch.addcmul(hi_v * hw, lo_v, lw)


def _step(tau: torch.Tensor, key: torch.Tensor, prob: PlacementProblem,
          cfg: PlacementConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One colony iteration: every ant assigns every layer, then the
    elitist update.  Returns (tau, best assignment (L,), its cost)."""
    n_layers, s, m = prob.n_layers, prob.n_stages, cfg.ants
    dev = tau.device
    c = _f32(prob.layer_costs, dev)
    mean_load = floatops.xla_sum(c) / floatops.const(s, c)
    one = floatops.const(1.0, c)
    loads = torch.zeros((m, s), dtype=torch.float32, device=dev)
    prev = torch.zeros((m,), dtype=torch.int64, device=dev)
    # the independent roulette's draws of every layer in one batch: layer
    # i's are bitwise sampling.uniform(fold_in(key, i), (m, S), 1e-6, 1)
    keys = sampling.fold_in(key, torch.arange(n_layers, device=dev))
    u = sampling.uniform(keys, (m, s), minval=1e-6, maxval=1.0)  # (L, m, S)
    picks = []
    for i in range(n_layers):
        # heuristic: prefer under-loaded stages and staying on prev stage
        head = one / (one + loads / mean_load)              # (m, S)
        stay = 1.0 + 0.5 * torch.nn.functional.one_hot(prev, s).to(
            torch.float32)
        w = _pow(tau[i][None, :], cfg.alpha) * _pow(head * stay, cfg.beta)
        pick = torch.argmax(w * u[i], dim=-1).to(torch.int32)  # iroulette
        loads = loads + torch.nn.functional.one_hot(
            pick.long(), s).to(torch.float32) * c[i]
        prev = pick.long()
        picks.append(pick)
    assign = torch.stack(picks, dim=1)                      # (m, L) int32
    costs = _cost(prob, assign, fused=True)

    # Elitist AS update: only the best quartile of ants deposits, weighted
    # by solution quality.
    thresh = _quantile(costs, 0.25)
    wq = floatops.const(cfg.q, costs) * costs.min()
    w = torch.where(costs <= thresh,
                    wq / torch.clamp_min(costs, 1e-9),
                    torch.zeros_like(costs))
    onehot = torch.nn.functional.one_hot(assign.long(), s).to(torch.float32)
    dep = _onehot_sum(onehot, w, 0, True)                   # (L, S)
    tau = torch.addcmul(dep, floatops.const(1.0 - cfg.rho, tau), tau)
    best = torch.argmin(costs)
    return tau, assign[best], costs[best]


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` for a static exponent, with XLA's folding of the
    exponents 0, 1 and 2 (the C library's power otherwise)."""
    if p == 1.0:
        return x
    if p == 2.0:
        return x * x
    if p == 0.0:
        return torch.ones_like(x)
    return floatops.powf(x, floatops.const(p, x))


def solve(prob: PlacementProblem, cfg: PlacementConfig = PlacementConfig(),
          device: _device.DeviceLike = None) -> tuple[np.ndarray, float]:
    """Run the colony; returns the best assignment (L,) int32 as NumPy and
    its cost as a float.  Runs on the GPU unless ``device`` says
    otherwise."""
    dev = _device.resolve(device)
    tau = torch.ones((prob.n_layers, prob.n_stages), dtype=torch.float32,
                     device=dev)
    key = sampling.prng_key(cfg.seed, dev)
    it_keys = sampling.fold_in(key, torch.arange(cfg.iterations, device=dev))
    best_a: Optional[np.ndarray] = None
    best_c = np.inf
    for it in range(cfg.iterations):
        tau, a, cst = _step(tau, it_keys[it], prob, cfg)
        cst = float(cst)
        if cst < best_c:
            best_c = cst
            best_a = a.cpu().numpy()
    return best_a, best_c


def uniform_baseline(prob: PlacementProblem) -> tuple[np.ndarray, float]:
    """Contiguous equal-layer-count split (the standard default)."""
    n_layers, s = prob.n_layers, prob.n_stages
    assign = np.minimum((np.arange(n_layers) * s) // n_layers,
                        s - 1).astype(np.int32)
    return assign, float(assignment_cost(prob, torch.from_numpy(assign)))
