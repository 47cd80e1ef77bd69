"""Sparse tour construction: selection over K-wide candidate pages.

The PyTorch port of ``repro.sparse.construct``.  One construction step
gathers each ant's current city's candidate page -- (m, k) pheromone and
eta from the (n, k) store, extended by the city's O overflow slots -- and
selects within it; an ant whose whole page is visited takes the
nearest unvisited city by lazily computed distance (the page-fault
fallback).  No (n, n) tensor exists on this route; per-step transients are
(m, n) (the draw, the tabu list, the fallback's distances) and (m, k+O).

The reference's two draw contracts hold: the pure route draws the same
full-width (m, n) tensor as the dense pure selector (uniforms for
iroulette, Gumbel samples for gumbel) and gathers it at the candidates;
the kernel route (``use_pallas=True``) always draws uniforms and the
selection applies the per-mode transform.

Partial-ACO (Chitty): each ant copies the running best tour and rebuilds
one window of w cities through the same page selection.

The reference's ``lax.scan`` over the steps (``walk``) is, on the kernel
route with CUDA tensors, one launch of the ``sparse_walk`` kernel, which
runs every step of every ant and draws only at the candidates.  The pure
route, and the kernel route on CPU tensors, run it as a host loop
(``host_walk``).  ``walk.fallbacks`` counts the (ant, step) pairs that
took the page-fault fallback, as a device tensor (reset it to 0 to start a
count).

``construct_sparse_tours`` also builds over a stack of B instances (the
reference's step under ``vmap``, in the batched engine): (B, 2) keys, a
stacked problem and pages, per-slot ``n_actual`` as a (B,) int32 tensor.
On the kernel route that is one ``sparse_walk`` launch for the whole
stack; each instance's tours are bitwise its own construction.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree
from ..core import floatops, quant, sampling, strategies, tsp
from ..core.strategies import TourResult
from . import store
from .store import SparseProblem

_NEG_INF = -1e30


def _candidate_page(problem: SparseProblem, tau, ovf_city: torch.Tensor,
                    ovf_tau, cur: torch.Tensor, ewt: str):
    """Gather the extended candidate row for each ant's current city.

    Returns (cities, tau_row, tau_scale, eta_row, dist_row), all (m, k+O)
    (tau_scale only for an int8 store, else None).  Overflow slots follow
    the k candidates; empty slots map to the ant's own (always visited)
    city.  Overflow eta and distances are lazy.  A quantised store gives
    its raw payload in ``tau_row``; only the (m, K) transient is ever
    dequantised.
    """
    quantised = isinstance(tau, quant.QuantTau)
    tau_store = tau.q if quantised else tau
    c = cur.long()
    cities = problem.cand[c]                         # (m, k)
    tau_row = tau_store[c]
    int8 = quantised and tau.q.dtype == torch.int8
    tau_scale = tau.scale[c].expand(tau_row.shape) if int8 else None
    eta_row = problem.cand_eta[c]
    dist_row = problem.cand_dist[c]
    o = ovf_city.shape[-1]
    if o:
        oc = ovf_city[c]                             # (m, O)
        oc = torch.where(oc >= 0, oc, cur[:, None].to(oc.dtype))
        od = store.lazy_pair(problem.coords, cur[:, None].expand(oc.shape),
                             oc, ewt)
        oe = floatops.const(1.0, od) / torch.maximum(
            od, floatops.const(1e-10, od))
        ovf_store = ovf_tau.q if quantised else ovf_tau
        cities = torch.cat([cities, oc], dim=-1)
        tau_row = torch.cat([tau_row, ovf_store[c]], dim=-1)
        if int8:
            tau_scale = torch.cat(
                [tau_scale, ovf_tau.scale[c].expand(oc.shape)], dim=-1)
        eta_row = torch.cat([eta_row, oe], dim=-1)
        dist_row = torch.cat([dist_row, od], dim=-1)
    if int8:
        tau_scale = tau_scale.contiguous()
    return cities, tau_row, tau_scale, eta_row, dist_row


def _score(w: torch.Tensor, rand_full: torch.Tensor, cities: torch.Tensor,
           ants: torch.Tensor, selection: str) -> torch.Tensor:
    """Selection scores over the masked candidate weights ``w`` (m, K):
    the full-width draw gathered at the candidate cities."""
    if selection == "greedy":
        return w
    r = rand_full[ants[:, None], cities.long()]       # (m, K)
    if selection == "iroulette":
        return w * r
    if selection == "gumbel":
        logw = torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-38)),
                           floatops.const(_NEG_INF, w))
        return logw + r
    raise ValueError(f"selection {selection!r} unsupported on sparse route")


def _draw(key: torch.Tensor, m: int, n: int, selection: str,
          use_pallas: bool, draw_mode: str = "packed"
          ) -> Optional[torch.Tensor]:
    """The full-width (m, n) stochastic tensor for this step: on the pure
    route the dense pure selector's draw, on the kernel route uniforms (the
    kernel transforms them).  Greedy draws nothing; the kernel still takes
    an (m, n) operand, whose values it ignores."""
    if selection == "greedy":
        if use_pallas:
            return torch.zeros((m, n), dtype=torch.float32,
                               device=key.device)
        return None
    if draw_mode == "counter":
        if selection == "gumbel" and not use_pallas:
            return sampling.counter_gumbel(key, (m, n))
        return sampling.counter_uniform(key, (m, n), minval=1e-6,
                                        maxval=1.0)
    if selection == "gumbel" and not use_pallas:
        return sampling.gumbel_noise(key, (m, n))
    return sampling.uniform(key, (m, n), minval=1e-6, maxval=1.0)


def _fallback_nearest(problem: SparseProblem, cur: torch.Tensor,
                      visited: torch.Tensor, ewt: str,
                      n_actual: Optional[int]) -> torch.Tensor:
    """Nearest unvisited city by lazy distance: the O(m·n) page-fault
    step."""
    rows = store.lazy_rows(problem.coords, cur, ewt)             # (m, n)
    bad = visited
    if n_actual is not None:
        idx = torch.arange(rows.shape[-1], device=rows.device)
        bad = bad | (idx[None, :] >= n_actual)
    rows = torch.where(bad, floatops.const(float("inf"), rows), rows)
    return torch.argmin(rows, dim=-1).to(torch.int32)


def _step(problem: SparseProblem, tau, ovf_city, ovf_tau, cur, visited,
          key, m: int, selection: str, alpha: float, beta: float, ewt: str,
          use_pallas: bool, draw_mode: str, n_actual: Optional[int],
          select=None):
    """One selection step for every ant -> (next city, edge length, have).
    The kernel route selects with ``select`` (``kernels.ops.sparse_select``'s
    signature), by default the plain version of the ``sparse_select``
    kernel."""
    n = problem.n
    ants = torch.arange(m, device=cur.device)
    cities, tau_row, tau_scale, eta_row, dist_row = _candidate_page(
        problem, tau, ovf_city, ovf_tau, cur, ewt)
    rand_full = _draw(key, m, n, selection, use_pallas, draw_mode)
    if use_pallas:
        if select is None:
            from ..kernels import sparse_select as _ss
            pos, have = _ss.sparse_select_quant_plain(
                tau_row, tau_scale, eta_row, cities, visited, rand_full,
                alpha, beta, selection)
        else:
            pos, have = select(tau_row, eta_row, cities, visited, rand_full,
                               alpha, beta, selection, tau_scale=tau_scale)
        have = have.bool()
    else:
        cmask = ~visited[ants[:, None], cities.long()]
        tau_row_f = quant.dequantise_rows(tau_row, tau_scale)
        w = strategies.choice_matrix(tau_row_f, eta_row, alpha, beta) * cmask
        have = w.sum(-1) > 0
        pos = torch.argmax(_score(w, rand_full, cities, ants, selection),
                           dim=-1)
    pos = pos.long()
    nxt_c = cities[ants, pos]
    d_c = dist_row[ants, pos]
    # The reference runs the fallback under lax.cond only when some ant
    # needs it; computing it always and selecting per ant gives the same
    # tours and needs no host synchronisation per step.
    nxt_fb = _fallback_nearest(problem, cur, visited, ewt, n_actual)
    d_fb = store.lazy_pair(problem.coords, cur, nxt_fb, ewt)
    return (torch.where(have, nxt_c, nxt_fb), torch.where(have, d_c, d_fb),
            have)


def host_walk(problem: SparseProblem, tau, ovf_city, ovf_tau, start,
              visited, keys, m: int, selection: str, alpha: float,
              beta: float, ewt: str, use_pallas: bool, draw_mode: str,
              n_actual: Optional[int] = None, select=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step loop on the host from ``start``, one step per key;
    ``visited`` is updated in place; ``select`` as in ``_step``.  On a
    padded instance (a tour from position 0) steps t = i + 1 >= n_actual
    emit the phantom tail in index order at length 0.  Returns the emitted
    cities and edge lengths, (S, m) each, and the fallback steps per ant
    (m,) int32."""
    dev = start.device
    ants = torch.arange(m, device=dev)
    cur = start
    steps, dsteps, haves = [], [], []
    for i in range(keys.shape[0]):
        t = i + 1
        if n_actual is not None and t >= n_actual:
            nxt = torch.full((m,), t, dtype=torch.int32, device=dev)
            dstep = torch.zeros((m,), dtype=torch.float32, device=dev)
        else:
            nxt, dstep, have = _step(problem, tau, ovf_city, ovf_tau, cur,
                                     visited, keys[i], m, selection, alpha,
                                     beta, ewt, use_pallas, draw_mode,
                                     n_actual, select)
            haves.append(have)
        visited[ants, nxt.long()] = True
        cur = nxt
        steps.append(nxt)
        dsteps.append(dstep)
    fallbacks = ((~torch.stack(haves)).sum(0).to(torch.int32) if haves
                 else torch.zeros(m, dtype=torch.int32, device=dev))
    return torch.stack(steps), torch.stack(dsteps), fallbacks


def host_walks(problem: SparseProblem, tau, ovf_city, ovf_tau, start,
               visited, keys, selection: str, alpha: float, beta: float,
               ewt: str, use_pallas: bool, draw_mode: str, n_actual=None,
               active=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``host_walk`` from ``start`` with m = start's last dimension; over a
    stacked problem (B, n, k) a loop over the active instances, each
    operand with a leading B, ``n_actual`` B host ints (a sequence or a
    (B,) tensor); an inactive instance's results are zero and its tabu
    rows untouched."""
    m = start.shape[-1]
    if problem.cand.dim() == 2:
        return host_walk(problem, tau, ovf_city, ovf_tau, start, visited,
                         keys, m, selection, alpha, beta, ewt, use_pallas,
                         draw_mode, None if n_actual is None
                         else int(n_actual))
    from ..kernels import _build
    nb, steps, dev = start.shape[0], keys.shape[-2], start.device
    cities = torch.zeros((nb, steps, m), dtype=torch.int32, device=dev)
    dists = torch.zeros((nb, steps, m), dtype=torch.float32, device=dev)
    fallbacks = torch.zeros((nb, m), dtype=torch.int32, device=dev)
    acts = [True] * nb if active is None else list(active)
    for b, n_act in enumerate(_build.slot_ints(n_actual, nb)):
        if acts[b]:
            out = host_walk(problem.slot(b, n_act), tree.index(tau, b),
                            ovf_city[b], tree.index(ovf_tau, b), start[b],
                            visited[b], keys[b], m, selection, alpha, beta,
                            ewt, use_pallas, draw_mode, n_act)
            cities[b], dists[b], fallbacks[b] = out
    return cities, dists, fallbacks


def walk(problem: SparseProblem, tau, ovf_city, ovf_tau, start, visited,
         keys, m: int, selection: str, alpha: float, beta: float, ewt: str,
         use_pallas: bool, draw_mode: str, n_actual=None, active=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The construction walk from ``start``, one step per key (see
    ``host_walk``): on the kernel route through ``kernels.ops.sparse_walk``
    (one launch on CUDA tensors, a stack included), on the pure route as a
    host loop.  Returns the emitted cities and edge lengths, (S, m) each
    ((B, S, m) over a stack)."""
    if use_pallas:
        from ..kernels import ops as kops
        steps, dsteps, fallbacks = kops.sparse_walk(
            problem, tau, ovf_city, ovf_tau, start, visited, keys, selection,
            alpha, beta, ewt, draw_mode, n_actual, active)
    else:
        steps, dsteps, fallbacks = host_walks(
            problem, tau, ovf_city, ovf_tau, start, visited, keys, selection,
            alpha, beta, ewt, False, draw_mode, n_actual, active)
    walk.fallbacks = walk.fallbacks + fallbacks.sum()
    return steps, dsteps


walk.fallbacks = 0


def construct_sparse_tours(key: torch.Tensor, problem: SparseProblem, tau,
                           ovf_city: torch.Tensor, ovf_tau, m: int,
                           selection: str, alpha: float, beta: float,
                           ewt: str, use_pallas: bool = False,
                           draw_mode: str = "packed", n_actual=None,
                           active=None) -> TourResult:
    """Build m complete tours from candidate pages only.

    tau (n, k) candidate-edge pheromone (or its QuantTau); ovf_city /
    ovf_tau (n, O) adopted off-list pages.  ``ewt`` selects the lazy
    distances' rounding rule.  ``selection``: iroulette | gumbel | greedy.

    Over a stack: ``key`` (B, 2), the problem and pages (B, n, ...),
    ``n_actual`` the problem's counts as a (B,) int32 tensor on its device
    (built from the host tuple when not given), ``active`` B host flags for
    the kernel route's walk (None: all); tours (B, m, n) and lengths
    (B, m), an inactive instance's rows unspecified.
    """
    if key.dim() == 1:
        res = construct_sparse_tours(
            key[None], problem.stacked(), tree.map(lambda x: x[None], tau),
            ovf_city[None], tree.map(lambda x: x[None], ovf_tau), m,
            selection, alpha, beta, ewt, use_pallas, draw_mode)
        return TourResult(res.tours[0], res.lengths[0])
    nb, n = problem.cand.shape[:2]
    dev = problem.cand.device
    if n_actual is None:
        from ..core import aco
        n_actual = aco.slot_n_actual(problem, dev)
    ks = sampling.split(key)
    kp, kc = ks[:, 0], ks[:, 1]
    start = strategies.place_ants(kp, m, n, n_actual)             # (B, m)
    visited = torch.zeros((nb, m, n), dtype=torch.bool, device=dev)
    visited.scatter_(2, start.long()[..., None], True)
    keys = sampling.fold_in(kc, torch.arange(1, n, device=dev))   # (B, S, 2)
    steps, dsteps = walk(problem, tau, ovf_city, ovf_tau, start, visited,
                         keys, m, selection, float(alpha), float(beta), ewt,
                         use_pallas, draw_mode,
                         n_actual if use_pallas else problem.n_actual,
                         active)
    tours = torch.cat([start[:, None, :], steps], dim=1)
    tours = tours.transpose(1, 2).contiguous()                    # (B, m, n)
    # (m, n) per-edge arrays, closing edge last: the dense _finish's array
    # and sum order
    edges = torch.cat([dsteps.transpose(1, 2),
                       torch.zeros((nb, m, 1), dtype=torch.float32,
                                   device=dev)], dim=-1)
    if n_actual is not None:
        idx = torch.arange(n, device=dev)
        n_act = n_actual.long().reshape(nb, 1, 1)
        last = tours.gather(2, (n_act - 1).expand(nb, m, 1))[..., 0]
        d_close = store.pair_lookup(problem, last, tours[..., 0], ewt)
        edges = torch.where(idx == n_act - 1, d_close[..., None], edges)
        edges = torch.where(idx < n_act, edges, torch.zeros_like(edges))
    else:
        edges[..., -1] = store.pair_lookup(problem, tours[..., -1],
                                           tours[..., 0], ewt)
    return TourResult(tours, tsp.edge_sum(edges))


def partial_tours(key: torch.Tensor, problem: SparseProblem, tau,
                  ovf_city: torch.Tensor, ovf_tau, best_tour: torch.Tensor,
                  best_len: torch.Tensor, m: int, window: int,
                  selection: str, alpha: float, beta: float, ewt: str,
                  use_pallas: bool = False,
                  draw_mode: str = "packed") -> TourResult:
    """Partial-ACO mutation: each ant rebuilds one window of the running
    best tour by candidate-page selection.

    Lengths are delta-updated (best_len - old segment + new segment) in
    float32, the segment sums in the reference's compiled order
    (``floatops.xla_sum``); the caller re-measures the accepted best
    exactly.  Needs a valid best_tour, window <= n - 2 and an unpadded
    problem.
    """
    n = problem.n
    window = max(1, min(window, n - 2))
    dev = problem.cand.device
    ants = torch.arange(m, device=dev)
    kp, kc = sampling.split(key)
    # window starts in [1, n - window], so that the anchor (s-1) and the
    # reconnect city (s+window, mod n) both exist
    s = sampling.randint(kp, (m,), 1, n - window + 1).long()
    wpos = s[:, None] + torch.arange(window, device=dev)[None, :]
    bt = best_tour.long()
    wcities = bt[wpos]                                          # (m, w)
    anchor = best_tour[s - 1]                                   # (m,)
    reconnect = best_tour[(s + window) % n]                     # (m,)
    visited = torch.ones((m, n), dtype=torch.bool, device=dev)
    visited[ants[:, None], wcities] = False
    keys = sampling.fold_in(kc, torch.arange(window, device=dev))
    steps, dsteps = walk(problem, tau, ovf_city, ovf_tau, anchor, visited,
                         keys, m, selection, float(alpha), float(beta), ewt,
                         use_pallas, draw_mode)
    new_window = steps.T.to(torch.int32)                        # (m, w)
    new_cost = floatops.xla_sum(dsteps.T) + store.pair_lookup(
        problem, new_window[:, -1], reconnect, ewt)
    # the w+1 edges of the best tour that the mutation replaces
    opos = s[:, None] - 1 + torch.arange(window + 1, device=dev)[None, :]
    oa = best_tour[opos]
    ob = best_tour[(opos + 1) % n]
    old_cost = floatops.xla_sum(store.pair_lookup(problem, oa, ob, ewt))
    tours = best_tour[None, :].expand(m, n).clone()
    tours[ants[:, None], wpos] = new_window
    lengths = best_len - old_cost + new_cost
    return TourResult(tours.to(torch.int32), lengths)
