"""Batched multi-instance ACO engine: one call advances B colonies.

The PyTorch port of ``repro.solver.engine``.  ``run_batch`` advances a
stacked state of B colonies by up to ``max_iters`` iterations.  Each
engine iteration steps every still-active colony once; a colony whose
absolute budget is reached (or which went ``patience`` iterations without
improving) is frozen, so its trajectory -- the PRNG key included -- does
not depend on how long the rest of the batch runs.  The loop ends as soon
as every colony is done.

Design, two routes:

- the kernel routes that take the instance axis step the whole stack at
  once, whatever the number of active slots:
  - dense (``aco.batched_route``: ``use_pallas=True``, the fused or the
    ``pallas`` construction, with or without local search, no Hyper;
    AS, MMAS or ACS over any ``tau_dtype``, metrics on or off):
    ``core.aco.colony_step_batch``, one ``split`` of the (B, 2) keys, one
    ``fused_walk`` launch (``pallas``: one ``choice_info`` launch and one
    ``tour_select`` launch a step), one local-search pass over the
    stack's tours (one ``two_opt_best`` launch a round; the ``ls_every``
    gate per slot, from the host mirror of the slots' iterations) and one
    ``pheromone_update`` launch per engine iteration;
  - sparse (``kind="sparse"`` on ``sparse.aco.batched_route``:
    ``use_pallas=True``, the standard construction; AS, MMAS or ACS over
    any ``tau_dtype``): ``sparse.aco.sparse_colony_step_batch``, one
    ``sparse_walk`` launch per engine iteration and the epilogue over
    (B, ...) pages.
  The kernels skip a finished slot, and only the active slots' rows are
  written back (the reference's ``where``-freeze).  ``colony_step`` and
  ``sparse_colony_step`` are those functions' B = 1 cases, so batched ==
  solo is bitwise by construction;
- every other route (the pure routes, Hyper) is a host loop over the
  active slots, each calling ``core.aco.colony_step`` (or
  ``sparse.aco.sparse_colony_step``) on that slot's view of the stacked
  tensors.

The done mask is read from the card once per engine iteration, and only
under ``patience``: budgets compare against a host mirror of each slot's
iteration count.

Multi-device placement (``mesh=``) and the program cache (``programs=``)
are not ported yet (ROADMAP queue 1 items 14 and 15).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from .. import tree
from ..core import aco, sampling, tsp
from ..sparse import aco as sparse_aco
from ..sparse.store import SparseColonyState
from . import batch as batch_mod


def init_state(instance: tsp.TSPInstance, cfg: aco.ACOConfig, seed: int,
               n_pad: int, hyper: Optional[aco.Hyper] = None,
               device: _device.DeviceLike = None) -> aco.ColonyState:
    """Fresh single-slot ColonyState padded to ``n_pad``: tau0 from the
    *real* instance (and the Hyper's rho for MMAS), as a solo run starts."""
    dev = _device.resolve(device)
    tau0 = aco.initial_tau(
        instance, cfg, rho=None if hyper is None else float(hyper.rho))
    return aco.ColonyState(
        tau=aco.make_tau(torch.full((n_pad, n_pad), float(np.float32(tau0)),
                                    dtype=torch.float32, device=dev), cfg),
        best_tour=torch.arange(n_pad, dtype=torch.int32, device=dev),
        best_len=torch.tensor(np.float32(np.inf), device=dev),
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        key=sampling.prng_key(seed, dev),
    )


def init_states(instances: Sequence[tsp.TSPInstance], cfg: aco.ACOConfig,
                seeds: Sequence[int], n_pad: int,
                hypers: Optional[Sequence[Optional[aco.Hyper]]] = None,
                device: _device.DeviceLike = None) -> aco.ColonyState:
    """Stacked ColonyState for a bucket: tau0 from each *real* instance."""
    dev = _device.resolve(device)
    if hypers is None:
        hypers = [None] * len(instances)
    return tree.stack([init_state(inst, cfg, seed, n_pad, h, dev)
                       for inst, seed, h in zip(instances, seeds, hypers)])


def init_sparse_states(instances: Sequence[tsp.TSPInstance],
                       cfg: aco.ACOConfig, seeds: Sequence[int],
                       n_pad: int, device: _device.DeviceLike = None
                       ) -> SparseColonyState:
    """Stacked SparseColonyState for one (n_pad, k) bucket: tau0 per
    *real* instance, one slot per instance."""
    dev = _device.resolve(device)
    return tree.stack([sparse_aco.init_sparse_colony(inst, cfg, seed, n_pad,
                                                     device=dev)
                       for inst, seed in zip(instances, seeds)])


def _host_ints(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.tolist()]
    return [int(v) for v in x]


def _check_aligned(problem, states, b: int) -> None:
    """The walk kernel reads 16-byte chunks aligned in the flat array: a
    slot's view must start on a 16-byte boundary (it does for every bucket
    of ``batch.bucket_size``); the slot is never copied to make it so."""
    views = (problem.dist[b], problem.eta[b]) + tuple(
        tree.flatten(tree.index(states.tau, b)))
    if any(v.data_ptr() % 16 for v in views):
        raise ValueError(
            f"slot {b} of a (B, {problem.dist.shape[-1]}, "
            f"{problem.dist.shape[-1]}) stack is not 16-byte aligned; use a "
            "power-of-two bucket (batch.bucket_size)")


def run_batch(problem, states, budgets, cfg: aco.ACOConfig, max_iters: int,
              patience: int = 0, since: Optional[torch.Tensor] = None,
              donate: bool = False, mesh=None, kind: str = "dense",
              ewt: str = "EUC_2D", mets=None, programs=None):
    """Advance B colonies by up to ``max_iters`` more iterations each.

    problem: the stacked ``Problem`` (``kind="dense"``) or ``SparseProblem``
    (``kind="sparse"``, with the bucket's rounding rule ``ewt``) of a
    batch.  budgets: (B,) *absolute* per-instance iteration targets
    (a tensor or a sequence of ints), compared against each slot's
    iteration count, so chunked calls compose exactly with one long call.
    patience: >0 also stops an instance after that many consecutive
    non-improving iterations.  since: (B,) int32 counts of consecutive
    non-improving iterations from a previous chunk (default zeros),
    returned updated.  mets: with ``cfg.metrics``, (B,)-stacked
    ``obs.StepMetrics`` rows from a previous chunk (default zeros),
    frozen under the same mask and returned as a third element.
    donate: update ``states``/``since``/``mets`` in place and return them;
    without it the inputs are left as they were.  The results are the
    same either way.

    Returns ``(states, since)``, or ``(states, since, mets)`` with metrics.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_batch(mesh=...): multi-device placement is not ported yet "
            "(ROADMAP queue 1 item 14)")
    if programs is not None:
        raise NotImplementedError(
            "run_batch(programs=...): the program cache is not ported yet "
            "(ROADMAP queue 1 item 15)")
    if kind not in ("dense", "sparse"):
        raise ValueError(f"unknown kind {kind!r}")
    dev = states.key.device
    n_slots = states.key.shape[0]
    budgets_h = _host_ints(budgets)
    if len(budgets_h) != n_slots:
        raise ValueError(f"{len(budgets_h)} budgets for {n_slots} slots")
    if since is None:
        since = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    metrics_on = cfg.metrics
    if metrics_on and mets is None:
        from ..obs import metrics as obs_metrics
        mets = obs_metrics.zeros_batch(n_slots, dev)
    if not metrics_on:
        mets = None

    if kind == "dense" and cfg.use_pallas:
        for b in range(n_slots):
            _check_aligned(problem, states, b)
    it_h = _host_ints(states.iteration)            # one read per call
    if kind == "dense" and aco.batched_route(cfg, problem):
        def step_stack(s, active, n_act, its):
            return aco.colony_step_batch(problem, s, cfg, active=active,
                                         n_actual=n_act, iterations=its)
    elif kind == "sparse" and sparse_aco.batched_route(cfg):
        def step_stack(s, active, n_act, its):
            del its
            return sparse_aco.sparse_colony_step_batch(
                problem, s, cfg, ewt, active=active, n_actual=n_act)
    else:
        step_stack = None
    if step_stack is not None:
        return _run_stack(problem, states, budgets_h, it_h, max_iters,
                          patience, since, donate, mets, step_stack)

    if kind == "sparse":
        def step(p, s):
            return sparse_aco.sparse_colony_step(p, s, cfg, ewt)
    else:
        def step(p, s):
            return aco.colony_step(p, s, cfg)

    probs = [batch_mod.slot_problem(problem, b) for b in range(n_slots)]
    slots = [tree.index(states, b) for b in range(n_slots)]
    since_s = [since[b] for b in range(n_slots)]
    mets_s = [tree.index(mets, b) for b in range(n_slots)] \
        if metrics_on else None
    stepped = set()
    for _ in range(max_iters):
        stalled = [False] * n_slots
        if patience > 0:                           # one read an iteration
            stalled = [s >= patience
                       for s in torch.stack(since_s).tolist()]
        active = [b for b in range(n_slots)
                  if it_h[b] < budgets_h[b] and not stalled[b]]
        if not active:
            break
        for b in active:
            out = step(probs[b], slots[b])
            new = out[0]
            improved = new.best_len < slots[b].best_len
            since_s[b] = torch.where(improved, torch.zeros_like(since_s[b]),
                                     since_s[b] + 1)
            if metrics_on:
                mets_s[b] = out[2]._replace(stagnation=since_s[b])
            slots[b] = new
            it_h[b] += 1
            stepped.add(b)

    if donate:
        for b in sorted(stepped):
            tree.map(lambda dst, src: dst.copy_(src),
                     tree.index(states, b), slots[b])
            since[b] = since_s[b]
            if metrics_on:
                tree.map(lambda dst, src: dst.copy_(src),
                         tree.index(mets, b), mets_s[b])
        out_states, out_since, out_mets = states, since, mets
    else:
        out_states = tree.stack(slots)
        out_since = torch.stack(since_s)
        out_mets = tree.stack(mets_s) if metrics_on else None
    if metrics_on:
        return out_states, out_since, out_mets
    return out_states, out_since


def _run_stack(problem, states, budgets_h, it_h, max_iters, patience,
               since, donate, mets, step_stack):
    """``run_batch`` on a route that takes the instance axis: every engine
    iteration steps the whole stack with ``step_stack(states, active flags,
    n_actual, host iteration counts)`` (``colony_step_batch`` or
    ``sparse_colony_step_batch``) and writes back the rows of the slots
    that were active (all of them with one ``copy_`` per leaf when every
    slot was)."""
    n_slots = len(budgets_h)
    dev = states.key.device
    metrics_on = mets is not None
    if not donate:
        states = tree.map(torch.clone, states)
        since = since.clone()
        mets = tree.map(torch.clone, mets) if metrics_on else None
    n_act = aco.slot_n_actual(problem, dev)
    index_of = {}                       # active pattern -> device indices
    for _ in range(max_iters):
        stalled = [False] * n_slots
        if patience > 0:                           # one read an iteration
            stalled = [s >= patience for s in since.tolist()]
        act = tuple(it_h[b] < budgets_h[b] and not stalled[b]
                    for b in range(n_slots))
        if not any(act):
            break
        flags = None if all(act) else act
        out = step_stack(states, flags, n_act, tuple(it_h))
        new = out[0]
        improved = new.best_len < states.best_len
        new_since = torch.where(improved, torch.zeros_like(since), since + 1)
        fresh = [new, new_since]
        held = [states, since]
        if metrics_on:
            fresh.append(out[2]._replace(stagnation=new_since))
            held.append(mets)
        if flags is None:
            tree.map(lambda dst, src: dst.copy_(src), held, fresh)
        else:
            if act not in index_of:
                index_of[act] = torch.tensor(
                    [b for b in range(n_slots) if act[b]], dtype=torch.long,
                    device=dev)
            idx = index_of[act]
            tree.map(lambda dst, src: dst.index_copy_(
                0, idx, src.index_select(0, idx)), held, fresh)
        for b in range(n_slots):
            it_h[b] += act[b]
    if metrics_on:
        return states, since, mets
    return states, since


def solve_instances(instances: Sequence[tsp.TSPInstance], cfg: aco.ACOConfig,
                    iterations: Optional[Sequence[int]] = None,
                    seeds: Optional[Sequence[int]] = None,
                    n_pad: Optional[int] = None, patience: int = 0,
                    nn_k: Optional[int] = None,
                    hypers: Optional[Sequence[aco.Hyper]] = None,
                    mesh=None, device: _device.DeviceLike = None):
    """One-shot: batch, init, run; all instances in one bucket.  Returns
    (stacked states, batch).

    ``hypers``: per-instance alpha/beta/rho/q profiles (``aco.Hyper``), so
    one bucket mixes tuning profiles.  ``cfg.sparse`` runs the bucket on
    the O(n·k) paged representation (stacked SparseColonyState,
    SparseBatch); unsupported sparse combinations raise
    ``UnsupportedKernelRoute``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "solve_instances(mesh=...): multi-device placement is not "
            "ported yet (ROADMAP queue 1 item 14)")
    dev = _device.resolve(device)
    instances = tuple(instances)
    its = list(iterations) if iterations is not None else \
        [cfg.iterations] * len(instances)
    sds = list(seeds) if seeds is not None else \
        [cfg.seed + i for i in range(len(instances))]
    if cfg.sparse:
        if hypers is not None and any(h is not None for h in hypers):
            from ..kernels import ops as kops
            kops.check_kernel_route(hyper=True, sparse=True)
        sb = batch_mod.make_sparse_batch(instances, cfg.sparse_k, n_pad,
                                         device=dev)
        sparse_aco.check_sparse_route(cfg, masked=True)
        sstates = init_sparse_states(instances, cfg, sds, sb.n_pad, dev)
        sstates = run_batch(sb.problem, sstates, its, cfg, int(max(its)),
                            patience, donate=True, kind="sparse",
                            ewt=sb.ewt)[0]
        return sstates, sb
    b = batch_mod.make_batch(instances, n_pad,
                             nn_k if nn_k is not None else cfg.nn_k,
                             hypers=hypers, device=dev)
    states = init_states(instances, cfg, sds, b.n_pad, hypers, dev)
    # freshly built states are never reused: update them in place
    states = run_batch(b.problem, states, its, cfg, int(max(its)),
                       patience, donate=True)[0]
    return states, b


def collect(states, b: batch_mod.Batch) -> list[dict]:
    """Host-side per-instance results with phantom tails trimmed; dense
    and sparse batches alike."""
    lens = states.best_len.cpu().tolist()
    its = states.iteration.cpu().tolist()
    tours = states.best_tour.cpu().numpy()
    out = []
    for i, inst in enumerate(b.instances):
        out.append({
            "name": inst.name,
            "n": inst.n,
            "best_len": float(lens[i]),
            "best_tour": batch_mod.trim_tour(tours[i], inst.n),
            "iterations": int(its[i]),
            "known_optimum": inst.known_optimum,
        })
    return out
