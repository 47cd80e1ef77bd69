"""Sparse colony step: the dense ``core.aco.colony_step`` control flow on
the O(n·k) paged representation.

The PyTorch port of ``repro.sparse.aco``.  One iteration constructs (or
Partial-ACO-mutates) m tours over candidate pages, tracks the best,
deposits per variant and clamps (MMAS) or locally decays (ACS), with the
reference's step order and key discipline.  Route validation happens once,
up front, through ``kernels.ops.check_kernel_route``.

``sparse_colony_step_batch`` is the one implementation of the step: it
steps a stack of B colonies of one (n_pad, k) bucket on the kernel route
(one ``sparse_walk`` launch for the whole stack, the epilogue over
(B, ...) tensors), and ``sparse_colony_step`` is its B = 1 case, as
``core.aco.colony_step`` is of ``colony_step_batch``.  Partial-ACO and the
pure route take one instance at a time.

``run_sparse`` and ``init_sparse_colony`` take a ``device`` and run on
CUDA when none is given (``repro_torch.device.resolve``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from .. import tree
from ..core import aco as dense_aco
from ..core import floatops, quant, sampling, tsp
from ..core.strategies import TourResult
from . import construct, pheromone, store
from .store import SparseColonyState, SparseProblem


def check_sparse_route(cfg: dense_aco.ACOConfig, hyper: bool = False,
                       masked: bool = False) -> None:
    """Reject sparse x feature combinations the route cannot serve."""
    from ..kernels import ops as kops
    kops.check_kernel_route(masked=masked, hyper=hyper, sparse=True,
                            selection=cfg.selection,
                            local_search=cfg.local_search,
                            construction=cfg.construction,
                            tau_dtype=cfg.tau_dtype)


def make_sparse_problem_cfg(instance: tsp.TSPInstance,
                            cfg: dense_aco.ACOConfig,
                            n_pad: Optional[int] = None,
                            device: _device.DeviceLike = None
                            ) -> SparseProblem:
    return store.make_sparse_problem(instance, cfg.sparse_k, n_pad,
                                     device=device)


def _make_ovf_tau(ovf_f32: torch.Tensor, cfg: dense_aco.ACOConfig):
    """Overflow pages follow the store dtype but never carry an
    error-feedback residual: slots churn, so a carried per-slot residual
    would attribute one edge's error to another."""
    if not quant.is_quantised(cfg.tau_dtype):
        return ovf_f32
    return quant.quantise(ovf_f32, cfg.tau_dtype)


def init_sparse_colony(instance: tsp.TSPInstance, cfg: dense_aco.ACOConfig,
                       seed: Optional[int] = None,
                       n_pad: Optional[int] = None,
                       device: _device.DeviceLike = None
                       ) -> SparseColonyState:
    """Fresh sparse state: tau0 on every page, empty overflow slots.

    Partial-ACO mutates a running best, so it starts from the NN tour; the
    standard route starts from the identity tour at +inf, as the dense
    init does.  The page width is ``sparse_k``, not clamped to n-1: the
    problem pages keep surplus self-sentinel columns and tau lines up with
    them column for column.
    """
    dev = _device.resolve(device)
    n = instance.n
    n_pad = n if n_pad is None else n_pad
    k = max(1, cfg.sparse_k)
    tau0 = store.sparse_initial_tau(instance, cfg)
    if cfg.construction == "partial":
        nn_tour, nn_len = store.sparse_nearest_neighbour_tour(instance)
        best_tour = torch.from_numpy(np.concatenate(
            [nn_tour, np.arange(n, n_pad, dtype=np.int32)])).to(dev)
        best_len = torch.tensor(np.float32(nn_len), device=dev)
    else:
        best_tour = torch.arange(n_pad, dtype=torch.int32, device=dev)
        best_len = torch.tensor(np.float32(np.inf), device=dev)
    o = cfg.sparse_overflow
    return SparseColonyState(
        tau=dense_aco.make_tau(torch.full((n_pad, k), float(np.float32(tau0)),
                                          dtype=torch.float32, device=dev),
                               cfg),
        tau_def=torch.tensor(np.float32(tau0), device=dev),
        ovf_city=torch.full((n_pad, o), store.OVF_EMPTY, dtype=torch.int32,
                            device=dev),
        ovf_tau=_make_ovf_tau(torch.zeros((n_pad, o), dtype=torch.float32,
                                          device=dev), cfg),
        best_tour=best_tour,
        best_len=best_len,
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        key=sampling.prng_key(cfg.seed if seed is None else seed, dev),
    )


def batched_route(cfg: dense_aco.ACOConfig) -> bool:
    """Whether ``sparse_colony_step_batch`` steps a stack in one pass: the
    kernel route (``use_pallas``) with the standard construction.  Any
    other route takes one instance at a time."""
    return cfg.use_pallas and cfg.construction == "data_parallel"


def sparse_colony_step_batch(problem: SparseProblem,
                             states: SparseColonyState,
                             cfg: dense_aco.ACOConfig, ewt: str,
                             active: Optional[Sequence[bool]] = None,
                             n_actual: Optional[torch.Tensor] = None
                             ) -> tuple:
    """One full sparse ACO iteration of B colonies stacked on a leading
    axis; mirrors ``core.aco.colony_step_batch``.

    ``problem`` is stacked: (B, n, ...) tensors and a host tuple of B
    ``n_actual`` ints (or None, unpadded); ``states`` a stacked
    SparseColonyState.  ``ewt``: TSPLIB rounding rule for the lazy
    off-list distances.  Returns (new_states, iteration_best_lengths
    (B,)); with ``cfg.metrics`` also the (B,)-stacked ``obs.StepMetrics``
    (tau statistics over each instance's (n, k) pages, overflow adoptions
    and evictions from its ovf_city delta), read-only and bitwise neutral
    to the state.  Row b of every result is bitwise the step of instance b
    alone.

    On ``batched_route`` the stack takes one ``sparse_walk`` launch and
    plain tensor work over (B, ...); every other route takes B = 1 only.
    ``active``: B host flags (None: all); the walk skips an inactive
    instance and its rows of the result are unspecified: the caller keeps
    its old state.  ``n_actual``: the problem's counts as a (B,) int32
    tensor on the states' device (``core.aco.slot_n_actual``), built here
    when not given.
    """
    n_slots = states.key.shape[0]
    n = problem.n
    m = cfg.num_ants(n)
    na = problem.n_actual
    dev = states.key.device
    check_sparse_route(cfg, masked=na is not None)
    if n_slots != 1 and not batched_route(cfg):
        raise ValueError("sparse_colony_step_batch steps a stack only on the "
                         "kernel route with the standard construction; step "
                         "other routes one instance at a time")
    # the walk launcher cannot read a device n_actual: its host values are
    # checked here, once for the whole stack
    if na is not None and not all(1 <= v <= n for v in na):
        raise ValueError(f"sparse_colony_step_batch: n_actual {na} not all "
                         f"in [1, {n}]")
    n_act = n_actual if n_actual is not None or na is None \
        else dense_aco.slot_n_actual(problem, dev)
    quantised = quant.is_quantised(cfg.tau_dtype)
    # the extra key feeds the two quantise-on-store steps (pages and
    # overflow); the fp32 branch keeps the two-way split
    ks = sampling.split(states.key, 3 if quantised else 2)   # (B, k, 2)
    key, k_tour = ks[:, 0], ks[:, 1]

    if cfg.construction == "partial":
        s0 = tree.index(states, 0)
        r = construct.partial_tours(
            k_tour[0], problem.slot(0, None if na is None else na[0]),
            s0.tau, s0.ovf_city, s0.ovf_tau, s0.best_tour, s0.best_len, m,
            cfg.partial_window, cfg.selection, cfg.alpha, cfg.beta, ewt,
            use_pallas=cfg.use_pallas, draw_mode=cfg.draw_mode)
        res = TourResult(r.tours[None], r.lengths[None])
    else:
        res = construct.construct_sparse_tours(
            k_tour, problem, states.tau, states.ovf_city, states.ovf_tau, m,
            cfg.selection, cfg.alpha, cfg.beta, ewt,
            use_pallas=cfg.use_pallas, draw_mode=cfg.draw_mode,
            n_actual=n_act, active=active)

    it_best_idx = torch.argmin(res.lengths, dim=-1)               # (B,)
    it_best_len = res.lengths.gather(-1, it_best_idx[:, None])[:, 0]
    it_best_tour = res.tours.gather(
        1, it_best_idx[:, None, None].expand(-1, 1, n))[:, 0]     # (B, n)
    if cfg.construction == "partial":
        # delta lengths are float32-approximate; re-measure the candidate
        # exactly before accepting, so the best sequence is monotone
        it_best_len = store.sparse_tour_length(
            problem.slot(0), it_best_tour, ewt)

    improved = it_best_len < states.best_len
    best_len = torch.where(improved, it_best_len, states.best_len)
    best_tour = torch.where(improved[:, None], it_best_tour,
                            states.best_tour)

    rho, q = cfg.rho, cfg.q
    if cfg.variant == "as":
        dep_tours = res.tours
        dep_w = floatops.const(q, res.lengths) / res.lengths
    elif cfg.variant == "mmas":
        if cfg.mmas_best == "global":
            dep_tours, dep_len = best_tour[:, None, :], best_len
        else:
            dep_tours, dep_len = it_best_tour[:, None, :], it_best_len
        dep_w = (floatops.const(q, dep_len) / dep_len)[:, None]
    elif cfg.variant == "acs":
        dep_tours = best_tour[:, None, :]
        dep_w = (floatops.const(rho * q, best_len) / best_len)[:, None]
    else:
        raise ValueError(f"unknown variant {cfg.variant}")

    adopt = cfg.variant in ("mmas", "acs") and cfg.sparse_overflow > 0
    # transient fp32 views for the update (construction above read the
    # resident payload directly)
    tau, tau_def, ovf_city, ovf_tau = pheromone.update_sparse(
        quant.dequantise(states.tau), states.tau_def, states.ovf_city,
        quant.dequantise(states.ovf_tau), problem.cand, dep_tours, dep_w,
        rho, adopt, n_act)

    clamp = None
    if cfg.variant == "mmas":
        tau_min, tau_max = dense_aco.mmas_bounds(best_len, cfg, n, n_act)
        lo, hi = tsp.per_slot(tau_min, 3), tsp.per_slot(tau_max, 3)
        tau = torch.clamp(tau, min=lo, max=hi)
        tau_def = torch.clamp(tau_def, min=tau_min, max=tau_max)
        ovf_tau = torch.clamp(ovf_tau, min=lo, max=hi)
        clamp = (tau_min, tau_max)
    elif cfg.variant == "acs":
        n_eff = floatops.const(n, best_len) if n_act is None \
            else n_act.to(torch.float32)
        tau0 = floatops.const(q, best_len) / (
            n_eff * torch.maximum(best_len, floatops.const(1e-9, best_len)))
        tau, tau_def, ovf_tau = pheromone.local_update_acs_sparse(
            tau, tau_def, ovf_tau, problem.cand, res.tours, cfg.xi, tau0,
            n_act)

    # quantise-on-store: pages and overflow each with their own key; the
    # metrics below read the exact fp32 pages of this step
    tau_store, ovf_store = tau, ovf_tau
    if quantised:
        k_q = sampling.split(ks[:, 2])                            # (B, 2, 2)
        tau_store = quant.requantise(tau, states.tau, cfg.tau_dtype,
                                     quant.round_key(cfg.tau_round,
                                                     k_q[:, 0]))
        ovf_store = quant.requantise(ovf_tau, states.ovf_tau, cfg.tau_dtype,
                                     quant.round_key(cfg.tau_round,
                                                     k_q[:, 1]))

    new_states = SparseColonyState(tau_store, tau_def, ovf_city, ovf_store,
                                   best_tour, best_len,
                                   states.iteration + 1, key)
    if not cfg.metrics:
        return new_states, it_best_len
    from ..obs import metrics as obs_metrics
    # overflow churn from the ovf_city delta: a slot whose city changed to
    # a non-empty one was adopted; if it held another city before, that
    # city was evicted to make room
    changed = ovf_city != states.ovf_city
    filled = ovf_city != store.OVF_EMPTY
    adopted = (changed & filled).sum(dim=(-2, -1), dtype=torch.int32)
    evicted = (changed & filled & (states.ovf_city != store.OVF_EMPTY)
               ).sum(dim=(-2, -1), dtype=torch.int32)
    mets = obs_metrics.step_metrics(
        res.lengths, it_best_len, best_len, improved, tau, clamp,
        ovf_adopted=adopted, ovf_evicted=evicted)
    return new_states, it_best_len, mets


def sparse_colony_step(problem: SparseProblem, state: SparseColonyState,
                       cfg: dense_aco.ACOConfig, ewt: str) -> tuple:
    """One full sparse ACO iteration; mirrors ``aco.colony_step``.

    ``ewt``: TSPLIB rounding rule for the lazy off-list distances.
    Returns (new_state, it_best_len); with ``cfg.metrics``, also an
    ``obs.StepMetrics`` (tau statistics over the (n, k) pages, overflow
    adoptions and evictions from the ovf_city delta), read-only and
    bitwise neutral to the state.

    The B = 1 case of ``sparse_colony_step_batch``: a solo step and a
    batched slot run the same arithmetic."""
    out = sparse_colony_step_batch(problem.stacked(),
                                   tree.map(lambda x: x[None], state), cfg,
                                   ewt)
    return tuple(tree.index(o, 0) for o in out)


def run_sparse(instance: tsp.TSPInstance, cfg: dense_aco.ACOConfig,
               state: Optional[SparseColonyState] = None,
               problem: Optional[SparseProblem] = None,
               device: _device.DeviceLike = None,
               checkpoint_cb=None, checkpoint_every: int = 0
               ) -> SparseColonyState:
    """Python-loop driver for one sparse colony; on the state's device
    when a state is given, else on ``device``."""
    check_sparse_route(cfg)
    dev = state.key.device if state is not None and device is None \
        else _device.resolve(device)
    if problem is None:
        problem = make_sparse_problem_cfg(instance, cfg, device=dev)
    if state is None:
        state = init_sparse_colony(instance, cfg, device=dev)
    ewt = instance.edge_weight_type
    for i in range(int(state.iteration), cfg.iterations):
        state = sparse_colony_step(problem, state, cfg, ewt)[0]
        if checkpoint_cb and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_cb(state)
    return state
