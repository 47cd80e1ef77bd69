"""The ACO engine: Ant System (paper's subject) plus MMAS / ACS variants.

The PyTorch port of ``repro.core.aco``: the same ``ACOConfig`` fields, the
same ``ColonyState``/``Problem`` containers as ``NamedTuple``s of tensors,
and the same iteration, step for step and draw for draw.  One colony
iteration (``colony_step``) constructs m tours, updates the pheromone and
tracks the best tour.

With ``use_pallas=True`` (the kernel route) construction and update run
through the CUDA kernels of ``kernels/``: ``construction="data_parallel"``
becomes the ``fused_select`` kernel step (no (n, n) choice matrix), other
constructions take the ``choice_info`` kernel, and the update is the fused
``pheromone_update`` kernel.  On CPU tensors the kernels' plain versions
run instead (``kernels/ops.py``).

Entry points (``make_problem``, ``init_colony``, ``run``) take a ``device``
and run on CUDA when none is given (``repro_torch.device.resolve``).
Combinations this slice does not port raise ``NotImplementedError`` naming
the ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import device as _device
from . import floatops, pheromone, sampling, strategies, tsp


@dataclasses.dataclass(frozen=True)
class ACOConfig:
    # Field for field the reference's ACOConfig, so that both packages'
    # configs are built from the same keyword arguments.
    alpha: float = 1.0
    beta: float = 2.0
    rho: float = 0.5
    q: float = 1.0                 # deposit numerator (1/C^k scaled by q)
    m: Optional[int] = None        # ants; None => m = n (paper §V)
    variant: str = "as"            # as | mmas | acs
    construction: str = "data_parallel"
    selection: str = "iroulette"   # iroulette (paper) | gumbel | roulette | greedy
    draw_mode: str = "packed"      # packed | counter (sampling.py)
    nn_k: int = 30                 # NN-list length (paper uses 30)
    deposit: str = "scatter"       # pheromone strategy (see pheromone.py)
    deposit_tile: int = 64
    iterations: int = 100
    seed: int = 0
    use_pallas: bool = False       # the kernel route (kernels/)
    local_search: str = "none"
    ls_every: int = 1
    ls_tours: str = "all"
    ls_rounds: int = 24
    ls_improvement: str = "best"
    ls_seg_max: int = 3
    mmas_best: str = "iteration"   # iteration | global
    q0: float = 0.9
    xi: float = 0.1
    sparse: bool = False
    sparse_k: int = 32
    sparse_overflow: int = 4
    partial_window: int = 64
    tau_dtype: str = "fp32"
    tau_round: str = "stochastic"
    tau_compensation: bool = False
    metrics: bool = False

    def num_ants(self, n: int) -> int:
        return self.m if self.m is not None else n


class ColonyState(NamedTuple):
    tau: torch.Tensor        # (n, n) float32 pheromone
    best_tour: torch.Tensor  # (n,) int32
    best_len: torch.Tensor   # () float32
    iteration: torch.Tensor  # () int32
    key: torch.Tensor        # (2,) int64 threefry key (two uint32 words)


class Problem(NamedTuple):
    """Device-resident constants for one TSP instance.

    ``n_actual`` is None for ordinary instances; for a padded instance
    (``tsp.pad_instance``: phantom cities at inf distance, eta exactly 0)
    it is the host int count of real cities and makes colony_step
    mask-aware.  ``hyper`` (per-instance hyperparameters) is not ported.
    """
    dist: torch.Tensor       # (n, n) float32
    eta: torch.Tensor        # (n, n) float32 (1/d)
    nn: torch.Tensor         # (n, k) int32
    n_actual: Optional[int] = None
    hyper: Optional[object] = None


def make_problem(instance: tsp.TSPInstance, nn_k: int = 30,
                 device: _device.DeviceLike = None) -> Problem:
    dev = _device.resolve(device)
    dist = torch.from_numpy(instance.distances()).to(dev)
    eta = tsp.heuristic_matrix(dist)
    nn = tsp.nn_lists(dist, min(nn_k, instance.n - 1))
    return Problem(dist, eta, nn)


def initial_tau(instance: tsp.TSPInstance, cfg: ACOConfig,
                rho: Optional[float] = None) -> float:
    """tau0 = m / C_nn (AS), 1/(rho C_nn) (MMAS), 1/(n C_nn) (ACS)."""
    d = instance.distances()
    _, c_nn = tsp.nearest_neighbour_tour(d)
    n = instance.n
    m = cfg.num_ants(n)
    if cfg.variant == "mmas":
        return 1.0 / ((cfg.rho if rho is None else rho) * c_nn)
    if cfg.variant == "acs":
        return 1.0 / (n * c_nn)
    return m / c_nn


def init_colony(instance: tsp.TSPInstance, cfg: ACOConfig,
                seed: Optional[int] = None,
                device: _device.DeviceLike = None) -> ColonyState:
    dev = _device.resolve(device)
    n = instance.n
    tau0 = np.float32(initial_tau(instance, cfg))
    return ColonyState(
        tau=torch.full((n, n), float(tau0), dtype=torch.float32, device=dev),
        best_tour=torch.arange(n, dtype=torch.int32, device=dev),
        best_len=torch.tensor(np.float32(np.inf), device=dev),
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        key=sampling.prng_key(cfg.seed if seed is None else seed, dev),
    )


def _check_supported(problem: Problem, cfg: ACOConfig) -> None:
    """The combinations this port does not serve yet, with their ROADMAP
    item; the kernel-route rejections keep the reference's messages."""
    from ..kernels import ops as kops
    if cfg.use_pallas or cfg.tau_dtype != "fp32":
        kops.check_kernel_route(masked=problem.n_actual is not None,
                                hyper=problem.hyper is not None,
                                tau_dtype=cfg.tau_dtype)
    todo = []
    if cfg.sparse:
        todo.append("sparse=True (ROADMAP queue 1 item 10)")
    if cfg.local_search != "none":
        todo.append(f"local_search={cfg.local_search!r} "
                    "(ROADMAP queue 1 item 8)")
    if cfg.tau_dtype != "fp32":
        todo.append(f"tau_dtype={cfg.tau_dtype!r} (ROADMAP queue 1 item 9)")
    if cfg.metrics:
        todo.append("metrics=True (ROADMAP queue 1 item 12)")
    if problem.hyper is not None:
        todo.append("Problem.hyper (ROADMAP queue 1 item 6)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _choice(tau: torch.Tensor, eta: torch.Tensor, cfg: ACOConfig,
            n_actual: Optional[int]) -> torch.Tensor:
    if cfg.use_pallas:
        from ..kernels import ops as kops
        return kops.choice_info(tau, eta, cfg.alpha, cfg.beta, n_actual)
    return strategies.choice_matrix(tau, eta, cfg.alpha, cfg.beta)


def colony_step(problem: Problem, state: ColonyState,
                cfg: ACOConfig) -> tuple[ColonyState, torch.Tensor]:
    """One full ACO iteration: construct m tours, update pheromone, track
    best.  Returns (new_state, iteration_best_length)."""
    _check_supported(problem, cfg)
    n = problem.dist.shape[0]
    m = cfg.num_ants(n)
    n_act = problem.n_actual
    rho, q = cfg.rho, cfg.q
    key, k_tour = sampling.split(state.key)
    tau_full = state.tau

    method = cfg.construction
    if cfg.use_pallas and method == "data_parallel":
        # The fused_select kernel does the whole construction step: no
        # (n, n) choice precompute on this route at all.
        method = "fused"
    choice_info = None
    if method != "fused":
        choice_info = _choice(tau_full, problem.eta, cfg, n_act)

    res = strategies.construct_tours(
        k_tour, problem.dist, choice_info, m, method=method,
        selection=cfg.selection, tau=tau_full, eta=problem.eta,
        alpha=cfg.alpha, beta=cfg.beta, n_actual=n_act,
        draw_mode=cfg.draw_mode)

    it_best_idx = torch.argmin(res.lengths)
    it_best_len = res.lengths[it_best_idx]
    it_best_tour = res.tours[it_best_idx]

    improved = it_best_len < state.best_len
    best_len = torch.where(improved, it_best_len, state.best_len)
    best_tour = torch.where(improved, it_best_tour, state.best_tour)

    if cfg.variant == "as":
        dep_tours, dep_w = res.tours, floatops.const(q, res.lengths) / res.lengths
    elif cfg.variant == "mmas":
        if cfg.mmas_best == "global":
            dep_tours, dep_len = best_tour[None, :], best_len
        else:
            dep_tours, dep_len = it_best_tour[None, :], it_best_len
        dep_w = (floatops.const(q, dep_len) / dep_len)[None]
    elif cfg.variant == "acs":
        dep_tours = best_tour[None, :]
        dep_w = (floatops.const(rho * q, best_len) / best_len)[None]
    else:
        raise ValueError(f"unknown variant {cfg.variant}")

    if cfg.use_pallas:
        from ..kernels import ops as kops
        tau = kops.pheromone_update(tau_full, dep_tours, dep_w, rho,
                                    n_actual=n_act)
    else:
        tau = pheromone.update(tau_full, dep_tours, dep_w, rho,
                               strategy=cfg.deposit, tile=cfg.deposit_tile,
                               n_actual=n_act)

    # MMAS/ACS normalisations use the real city count of padded instances.
    n_eff = n if n_act is None else n_act
    if cfg.variant == "mmas":
        tau_max = floatops.const(q, best_len) / (
            floatops.const(rho, best_len) * best_len)
        tau_min = tau_max / floatops.const(2.0 * n_eff, best_len)
        tau = torch.clamp(tau, min=tau_min, max=tau_max)
    elif cfg.variant == "acs":
        # Parallel-ACS local rule: decay edges crossed this iteration.
        f, t = pheromone.tour_edges(res.tours, n_act)
        tau0 = floatops.const(q, best_len) / (
            floatops.const(n_eff, best_len)
            * torch.maximum(best_len, floatops.const(1e-9, best_len)))
        ew = None
        if n_act is not None:
            # phantom-tail crossings must not decay (multiplicity 0)
            idx = torch.arange(n, device=tau.device)
            ew = (idx < n_act).to(tau.dtype).expand(res.tours.shape)
            ew = ew.reshape(-1)
        tau = pheromone.local_update_acs(tau, f.reshape(-1), t.reshape(-1),
                                         cfg.xi, tau0, w=ew)

    new_state = ColonyState(tau, best_tour, best_len, state.iteration + 1,
                            key)
    return new_state, it_best_len


def run(instance: tsp.TSPInstance, cfg: ACOConfig,
        state: Optional[ColonyState] = None,
        device: _device.DeviceLike = None,
        checkpoint_cb=None, checkpoint_every: int = 0) -> ColonyState:
    """Python-loop driver over ``cfg.iterations`` colony iterations; on the
    state's device when a state is given, else on ``device``."""
    if cfg.sparse:
        raise NotImplementedError(
            "not ported yet: sparse=True (ROADMAP queue 1 item 10)")
    dev = state.tau.device if state is not None and device is None \
        else _device.resolve(device)
    problem = make_problem(instance, cfg.nn_k, dev)
    if state is None:
        state = init_colony(instance, cfg, device=dev)
    start = int(state.iteration)
    for i in range(start, cfg.iterations):
        state = colony_step(problem, state, cfg)[0]
        if checkpoint_cb and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_cb(state)
    return state


def run_scan(problem: Problem, state: ColonyState, cfg: ACOConfig,
             iterations: int) -> tuple[ColonyState, torch.Tensor]:
    """Multi-iteration driver: (state, it_best per iteration)."""
    it_best = []
    for _ in range(iterations):
        state, best = colony_step(problem, state, cfg)
        it_best.append(best)
    return state, torch.stack(it_best)
