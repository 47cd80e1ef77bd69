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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import floatops
from ..core import pheromone as dense_ph
from .store import OVF_EMPTY


def _positions(cand: torch.Tensor, rows: torch.Tensor,
               targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each (row, target) pair: (found, position of target in
    cand[row]); position 0 when absent."""
    eq = cand[rows.long()] == targets[..., None]
    return eq.any(-1), torch.argmax(eq.to(torch.uint8), dim=-1)


def _page_stream(cand: torch.Tensor, rows: torch.Tensor,
                 targets: torch.Tensor, w: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat (n*k) page-cell index and value of each (row, target, w) in
    stream order, the value 0 where the target is off the row's list;
    and the found mask."""
    found, pos = _positions(cand, rows, targets)
    return (rows.long() * cand.shape[1] + pos,
            torch.where(found, w, torch.zeros_like(w)), found)


def _scatter(base: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with the values added in stream order."""
    return base.reshape(-1).clone().index_add_(0, idx, vals).view(
        base.shape)


def _streams(cand, tours, w, n_actual):
    """The forward (into row f) and reverse (into row t) deposit streams
    of (m, n) tours with (m,) weights."""
    f, t = dense_ph.tour_edges(tours, n_actual)
    fr, tr = f.reshape(-1), t.reshape(-1)
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


def _one_dir(cand, oc, ot, rows, cities, we, tau_def):
    """The reference's per-edge page update (match adds, a free slot adopts
    at tau_def + w, a full page evicts its weakest slot iff the newcomer
    is stronger), for distinct ``rows`` at once; in place."""
    page_c, page_t = oc[rows], ot[rows]                         # (P, O)
    onlist = (cand[rows] == cities[:, None]).any(-1)
    want = (we > 0) & ~onlist & (cities != rows)
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
                  tau_def: torch.Tensor, n_actual: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Give each off-list edge of one deposit tour (n,) with scalar weight
    ``w`` a bounded overflow slot on both endpoint rows (the reference's
    rules, in two row-parallel passes; see the module docstring).  Needs
    a valid tour over the real cities."""
    n_real = tour.shape[0] if n_actual is None else int(n_actual)
    real = tour[:n_real].long()
    pred = torch.roll(real, 1)                 # pred[0] = the closing edge's
    succ = torch.roll(real, -1)                # succ[-1] = real[0]
    first = torch.cat([succ[:1], pred[1:]])    # row real[0]: successor first
    second = torch.cat([pred[:1], succ[1:]])
    we = w.reshape(()).expand(n_real)
    oc, ot = ovf_city.clone(), ovf_tau.clone()
    for cities in (first, second):
        _one_dir(cand, oc, ot, real, cities, we, tau_def)
    return oc, ot


def update_sparse(tau: torch.Tensor, tau_def: torch.Tensor,
                  ovf_city: torch.Tensor, ovf_tau: torch.Tensor,
                  cand: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
                  rho: float, adopt: bool, n_actual: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Full sparse pheromone update: evaporation + deposit (+ adoption over
    every deposit tour, 1 for MMAS/ACS, when ``adopt`` and overflow slots
    exist)."""
    (fi, fv, _), (ri, rv, _) = _streams(cand, tours, w, n_actual)
    if 2 * tours.shape[0] < cand.shape[1]:
        # fewer deposits than page cells: XLA scatters them onto the
        # evaporated trail, forward stream first
        tau = _scatter(dense_ph.evaporate(tau, rho), torch.cat([fi, ri]),
                       torch.cat([fv, rv]))
    else:
        zeros = torch.zeros_like(tau)
        dep = _scatter(zeros, fi, fv) + _scatter(zeros, ri, rv)
        tau = torch.addcmul(dep, floatops.const(1.0 - rho, tau), tau)
    tau_def = dense_ph.evaporate(tau_def, rho)
    ovf_tau = dense_ph.evaporate(ovf_tau, rho)
    if adopt and ovf_city.shape[-1] > 0:
        for tour, we in zip(tours, w):
            ovf_city, ovf_tau = adopt_offlist(cand, ovf_city, ovf_tau, tour,
                                              we, tau_def, n_actual)
    return tau, tau_def, ovf_city, ovf_tau


def local_update_acs_sparse(tau: torch.Tensor, tau_def: torch.Tensor,
                            ovf_tau: torch.Tensor, cand: torch.Tensor,
                            tours: torch.Tensor, xi: float,
                            tau0: torch.Tensor,
                            n_actual: Optional[int] = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """ACS local rule on candidate edges: per-edge crossing counts, then
    the closed form tau <- (1-xi)^c tau + (1 - (1-xi)^c) tau0.  Off-list
    crossings are dropped; overflow pages keep their trail.  The first
    product is fused into the sum, as in the reference's compiled step
    over a float32 store (over a quantised one XLA's choice of product
    varies with the page width: ROADMAP queue 3)."""
    f, t = dense_ph.tour_edges(tours, n_actual)
    ew = torch.ones(f.shape, dtype=tau.dtype, device=tau.device)
    if n_actual is not None:
        idx = torch.arange(f.shape[-1], device=tau.device)
        ew = torch.where(idx[None, :] < n_actual, ew, torch.zeros_like(ew))
    fr, tr, ew = f.reshape(-1), t.reshape(-1), ew.reshape(-1)
    fi, fv, _ = _page_stream(cand, fr, tr, ew)
    ri, rv, _ = _page_stream(cand, tr, fr, ew)
    counts = _scatter(torch.zeros_like(tau), torch.cat([fi, ri]),
                      torch.cat([fv, rv]))
    factor = torch.pow(floatops.const(1.0 - xi, tau), counts)
    tau = torch.addcmul((1.0 - factor) * tau0, factor, tau)
    return tau, tau_def, ovf_tau
