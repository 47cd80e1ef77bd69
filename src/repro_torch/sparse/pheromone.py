"""Sparse pheromone update: O(n·k) evaporation, candidate-page deposits,
bounded overflow-slot adoption for off-list best-tour edges.

The PyTorch port of ``repro.sparse.pheromone``.  Trail lives at ``tau``
(n, k) on candidate edges, at ``ovf_tau`` (n, O) on adopted off-list
edges, and at the scalar ``tau_def`` for every other edge.

- Deposits scatter-add onto candidate positions with ``index_add_`` on
  flat indices, forward edges into row f and reverse edges into row t,
  then one add: the reference's edge-stream order, bitwise on the CPU; on
  the card bitwise where a cell gets one deposit (MMAS, ACS) and
  ulp-close for multi-ant AS.
- ``(1 - rho) * tau + dep`` follows the reference's compiled numbers,
  which depend on how XLA rewrites the update.  When the two deposit
  streams together hold fewer updates than the page has cells (2 m < k
  for m deposit tours: MMAS and ACS at k > 2), XLA scatters them onto the
  evaporated trail, forward stream first, each add rounded; otherwise it
  keeps the scatters and fuses the evaporation into their sum, one
  rounding (``torch.addcmul``).
- Adoption (MMAS/ACS, single deposit tour): the reference scans the
  tour's n edges, two page updates per edge.  Each update reads and
  writes only its own row's page, and in a valid tour every real city is
  the source of one real edge and the target of one: row ``tour[j]``
  (j >= 1) sees its predecessor first and then its successor, row
  ``tour[0]`` its successor first and the closing edge's predecessor
  last, and weight-0 phantom edges change nothing.  So ``adopt_offlist``
  runs two row-parallel passes, the first update of every row and then
  the second, the same operations on the same values in the same order
  per row as the scan.

Every function also takes a stack of B instances, the reference's update
under ``vmap`` in the batched engine: (B, n, k) pages, (B, n, O) overflow
pages, (B,) ``tau_def``, (B, m, n) tours with (B, m) weights and a (B,)
``n_actual`` tensor.  Each instance's cells sit in their own plane of one
flat scatter, and adoption runs over the B·n rows at once with phantom
positions masked, so every instance is bitwise its own update.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import floatops, tsp
from ..core import pheromone as dense_ph
from .store import OVF_EMPTY, flat_rows, take


def _positions(cand: torch.Tensor, rows: torch.Tensor,
               targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each (row, target) pair: (found, position of target in
    cand[row]); position 0 when absent."""
    eq = take(cand, rows) == targets[..., None]
    return eq.any(-1), torch.argmax(eq.to(torch.uint8), dim=-1)


def _page_stream(cand: torch.Tensor, rows: torch.Tensor,
                 targets: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat page-cell index and value of each (row, target, w) in stream
    order, the value 0 where the target is off the row's list; and the
    found mask."""
    found, pos = _positions(cand, rows, targets)
    return (flat_rows(cand, rows) * cand.shape[-1] + pos,
            torch.where(found, w, torch.zeros_like(w)), found)


def _scatter(base: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with the values added in stream order (over a
    stack, each instance's stream in its own plane)."""
    return base.reshape(-1).clone().index_add_(
        0, idx.reshape(-1), vals.reshape(-1)).view(base.shape)


def _streams(cand, tours, w, n_actual):
    """The forward (into row f) and reverse (into row t) deposit streams
    of (m, n) tours with (m,) weights ((B, m*n) of a stack's)."""
    f, t = dense_ph.tour_edges(tours, n_actual)
    fr, tr = f.flatten(-2), t.flatten(-2)
    wrep = dense_ph.edge_weights(tours, w, n_actual)
    return _page_stream(cand, fr, tr, wrep), _page_stream(cand, tr, fr, wrep)


def deposit_sparse(cand: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
                   n_actual: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate-page deposit for (m, n) tours with (m,) weights.

    Returns (dep (n, k), off (m*n,)): ``off`` carries the weight of each
    forward edge that is off its row's candidate list (0 otherwise).
    """
    (fi, fv, found), (ri, rv, _) = _streams(cand, tours, w, n_actual)
    zeros = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    return (_scatter(zeros, fi, fv) + _scatter(zeros, ri, rv),
            torch.where(found, torch.zeros_like(fv),
                        dense_ph.edge_weights(tours, w, n_actual)))


def _one_dir(cand, oc, ot, rows, local, cities, we, tau_def, real):
    """The reference's per-edge page update (match adds, a free slot adopts
    at tau_def + w, a full page evicts its weakest slot iff the newcomer
    is stronger), for distinct ``rows`` of the flattened pages at once (the
    instance's own city ids ``local``; only where ``real``, None: every
    row); in place."""
    page_c, page_t = oc[rows], ot[rows]                         # (P, O)
    onlist = (cand[rows] == cities[:, None]).any(-1)
    want = (we > 0) & ~onlist & (cities != local)
    if real is not None:
        want = want & real
    match = page_c == cities[:, None]
    free = page_c == OVF_EMPTY
    has_match, has_free = match.any(-1), free.any(-1)
    newval = tau_def + we
    j_match = torch.argmax(match.to(torch.uint8), dim=-1)
    j_free = torch.argmax(free.to(torch.uint8), dim=-1)
    j_min = torch.argmin(page_t, dim=-1)
    j = torch.where(has_match, j_match, torch.where(has_free, j_free, j_min))
    t_min = page_t.gather(-1, j_min[:, None])[:, 0]
    act = want & (has_match | has_free | (newval > t_min))
    c_j = page_c.gather(-1, j[:, None])[:, 0]
    t_j = page_t.gather(-1, j[:, None])[:, 0]
    val = torch.where(has_match, t_j + we, newval)
    oc[rows, j] = torch.where(act, cities.to(oc.dtype), c_j)
    ot[rows, j] = torch.where(act, val, t_j)


def adopt_offlist(cand: torch.Tensor, ovf_city: torch.Tensor,
                  ovf_tau: torch.Tensor, tour: torch.Tensor, w: torch.Tensor,
                  tau_def: torch.Tensor, n_actual=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Give each off-list edge of one deposit tour (n,) with scalar weight
    ``w`` a bounded overflow slot on both endpoint rows (the reference's
    rules, in two row-parallel passes; see the module docstring).  Needs
    a valid tour over the real cities.  Over a stack: ``tour`` (B, n),
    ``w`` and ``tau_def`` (B,), ``n_actual`` a (B,) tensor, one tour per
    instance in one pass over the B·n rows."""
    if tour.dim() == 1:
        oc, ot = adopt_offlist(
            cand[None], ovf_city[None], ovf_tau[None], tour[None],
            w.reshape(1), tau_def.reshape(1),
            None if n_actual is None else torch.tensor(
                [int(n_actual)], device=tour.device))
        return oc[0], ot[0]
    nb, n = tour.shape
    o = ovf_city.shape[-1]
    local = tour.long()
    # within the real prefix: pred[0] = the closing edge's, succ[-1] =
    # real[0]; phantom positions take no update
    if n_actual is None:
        pred, succ, real = local.roll(1, -1), local.roll(-1, -1), None
    else:
        idx = torch.arange(n, device=tour.device)
        n_real = n_actual.long().reshape(nb, 1)
        pred = local.gather(-1, torch.where(idx == 0, n_real - 1, idx - 1))
        succ = local.gather(-1, torch.where(idx >= n_real - 1, 0, idx + 1))
        real = (idx < n_real).reshape(-1)
    # row real[0]: successor first
    first = torch.cat([succ[:, :1], pred[:, 1:]], -1)
    second = torch.cat([pred[:, :1], succ[:, 1:]], -1)
    rows = flat_rows(cand, local).reshape(-1)
    we = w.reshape(nb, 1).expand(nb, n).reshape(-1)
    tdef = tau_def.reshape(nb, 1).expand(nb, n).reshape(-1)
    oc = ovf_city.reshape(nb * n, o).clone()
    ot = ovf_tau.reshape(nb * n, o).clone()
    flat = cand.reshape(nb * n, -1)
    for cities in (first, second):
        _one_dir(flat, oc, ot, rows, local.reshape(-1), cities.reshape(-1),
                 we, tdef, real)
    return oc.view(ovf_city.shape), ot.view(ovf_tau.shape)


def update_sparse(tau: torch.Tensor, tau_def: torch.Tensor,
                  ovf_city: torch.Tensor, ovf_tau: torch.Tensor,
                  cand: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
                  rho: float, adopt: bool, n_actual=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Full sparse pheromone update: evaporation + deposit (+ adoption over
    every deposit tour, 1 for MMAS/ACS, when ``adopt`` and overflow slots
    exist).  Over a stack as the module docstring says."""
    (fi, fv, _), (ri, rv, _) = _streams(cand, tours, w, n_actual)
    if 2 * tours.shape[-2] < cand.shape[-1]:
        # fewer deposits than page cells: XLA scatters them onto the
        # evaporated trail, forward stream first
        tau = _scatter(dense_ph.evaporate(tau, rho), torch.cat([fi, ri], -1),
                       torch.cat([fv, rv], -1))
    else:
        zeros = torch.zeros_like(tau)
        dep = _scatter(zeros, fi, fv) + _scatter(zeros, ri, rv)
        tau = torch.addcmul(dep, floatops.const(1.0 - rho, tau), tau)
    tau_def = dense_ph.evaporate(tau_def, rho)
    ovf_tau = dense_ph.evaporate(ovf_tau, rho)
    if adopt and ovf_city.shape[-1] > 0:
        for j in range(tours.shape[-2]):
            ovf_city, ovf_tau = adopt_offlist(cand, ovf_city, ovf_tau,
                                              tours[..., j, :], w[..., j],
                                              tau_def, n_actual)
    return tau, tau_def, ovf_city, ovf_tau


def local_update_acs_sparse(tau: torch.Tensor, tau_def: torch.Tensor,
                            ovf_tau: torch.Tensor, cand: torch.Tensor,
                            tours: torch.Tensor, xi: float,
                            tau0: torch.Tensor, n_actual=None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """ACS local rule on candidate edges: per-edge crossing counts, then
    the closed form tau <- (1-xi)^c tau + (1 - (1-xi)^c) tau0.  Off-list
    crossings are dropped; overflow pages keep their trail.  The first
    product is fused into the sum, as in the reference's compiled step
    over a float32 store (over a quantised one XLA's choice of product
    varies with the page width: ROADMAP queue 3).  A stack takes a (B,)
    ``tau0``."""
    f, t = dense_ph.tour_edges(tours, n_actual)
    ew = torch.ones(f.shape, dtype=tau.dtype, device=tau.device)
    if n_actual is not None:
        idx = torch.arange(f.shape[-1], device=tau.device)
        ew = torch.where(idx < tsp.per_slot(n_actual, f.dim()), ew,
                         torch.zeros_like(ew))
    fr, tr, ew = f.flatten(-2), t.flatten(-2), ew.flatten(-2)
    fi, fv, _ = _page_stream(cand, fr, tr, ew)
    ri, rv, _ = _page_stream(cand, tr, fr, ew)
    counts = _scatter(torch.zeros_like(tau), torch.cat([fi, ri], -1),
                      torch.cat([fv, rv], -1))
    factor = torch.pow(floatops.const(1.0 - xi, tau), counts)
    tau = torch.addcmul((1.0 - factor) * tsp.per_slot(tau0, tau.dim()),
                        factor, tau)
    return tau, tau_def, ovf_tau
