"""CUDA kernel: fused pheromone evaporation + deposit over an edge stream.

Replaces ``repro/kernels/pheromone_update.py::pheromone_update``
(``_update_kernel``, ``pallas_call`` at pheromone_update.py:94).  Source:
``csrc/pheromone_update.cu``.

Computes ``out = (1 - rho) * tau + sum_e w_e [frm_e = i][to_e = j]`` over
a directed-edge stream; endpoints outside the (n0, n1) matrix (the -1
padding) deposit nothing, and tau may be rectangular (an island's column
shard).  The Pallas kernel reduces one-hot slabs on the MXU per output
tile; on the H100 the paper's own winning version is native: pass 1
evaporates every cell, pass 2 runs one thread per four edges (16-byte
loads) doing an ``atomicAdd`` per edge that lands.  Pass 2 is launched as
pass 1's programmatic dependent, so it loads its edges while pass 1 runs.

Bound on the H100: bytes.  8 per cell (read tau, write out) plus 12 per
edge (frm, to, w): with E = 2 m n at n = m = 1002, about 32 MB, 9.6 us at
3.35 TB/s.  The float atomics on scattered cells, which the L2 performs,
hold it above that bound, as they hold ``index_add_``; PERF.md gives the
times.

Numerics: the evaporation product is rounded on its own, as in the Pallas
kernel; the plain version does the same and then adds the deposits with
``index_add_``.  A cell with at most one deposit (MMAS, the ACS deposit,
AS with one ant) is bitwise the plain version; a cell with several (AS)
sums in atomic order on the card: ulp-close, not reproducible run to run.

``pheromone_update_tours`` is the same update driven by the deposit tours,
the colony step's call (``ops.pheromone_update``): its edge stream is the
one ``core.pheromone.tour_edges`` / ``edge_weights`` build, which the
kernel never materialises.  One pass writes each city's next and previous
tour neighbour per ant (the inverse positions); then one warp owns one row
in shared memory and applies its deposits in the stream's index order, so
every cell, however many deposits it gets, is bitwise the CPU
``index_add_`` and the same from run to run.  Bound: 8 bytes per cell, 4
per (ant, position) and 4 per ant, 12.0 MB at n = m = 1002 (3.6 us at
3.35 TB/s).  ``pheromone_update_tours_plain`` is its plain version.
With a leading instance axis one launch updates a (B, n, n) stack, each
instance's ``n_actual`` from a (B,) device array, an inactive instance
skipped; the single update is its B = 1 case, one kernel body.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..analysis import ops
from ..core import floatops
from . import _build


def _decay(rho: float) -> float:
    # JAX rounds the Python float (1 - rho) to float32.
    return float(np.float32(1.0 - rho))


def pheromone_update_plain(tau: torch.Tensor, frm: torch.Tensor,
                           to: torch.Tensor, w: torch.Tensor,
                           rho: float) -> torch.Tensor:
    """tau (n0, n1); frm/to (E,) int directed edges; w (E,) -> new tau."""
    n0, n1 = tau.shape
    valid = (frm >= 0) & (frm < n0) & (to >= 0) & (to < n1)
    flat = torch.where(valid, frm.long() * n1 + to.long(),
                       torch.zeros_like(frm, dtype=torch.long))
    wv = torch.where(valid, w, torch.zeros_like(w))
    out = (floatops.const(_decay(rho), tau) * tau).reshape(-1)
    return out.index_add_(0, flat, wv).view(n0, n1)


def pheromone_update(tau: torch.Tensor, frm: torch.Tensor, to: torch.Tensor,
                     w: torch.Tensor, rho: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    n0, n1 = tau.shape
    dev = tau.device
    e = frm.shape[0]
    _build.require("pheromone_update tau", tau, torch.float32)
    _build.require("pheromone_update frm", frm, torch.int32, (e,), dev)
    _build.require("pheromone_update to", to, torch.int32, (e,), dev)
    _build.require("pheromone_update w", w, torch.float32, (e,), dev)
    out = torch.empty_like(tau)
    _build.launch("pheromone_update", dev, tau.data_ptr(), frm.data_ptr(),
                  to.data_ptr(), w.data_ptr(), out.data_ptr(), n0, n1, e,
                  _decay(rho))
    _build.count(pheromone_update)
    ops.kernel((tau, frm, to, w), (out,))
    return out


pheromone_update.launches = 0


def pheromone_update_shapes(tau: torch.Tensor, frm: torch.Tensor,
                            to: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's output on ``meta`` tensors (shapes only, nothing
    launched or counted as a launch): its bytes reported as the launch
    reports them."""
    out = torch.empty_like(tau)
    ops.kernel((tau, frm, to, w), (out,))
    return out


def pheromone_update_tours_plain(tau: torch.Tensor, tours: torch.Tensor,
                                 w: torch.Tensor, rho: float,
                                 n_actual=None,
                                 active: Optional[Sequence[bool]] = None
                                 ) -> torch.Tensor:
    """tau (n, n); tours (m, n) closed tours; w (m,) per-ant weights ->
    new tau.  The edge stream of ``core.pheromone.tour_edges`` /
    ``edge_weights`` (closing edge at n_actual - 1, phantom-tail edges at
    weight 0), each undirected edge in both directions, forward edges
    first, through ``pheromone_update_plain``.  A (B, n, n) tau is a stack
    of instances: a loop of single updates over the active ones, an
    inactive one's plane left at zero."""
    if tau.dim() == 3:
        nb = tau.shape[0]
        out = torch.zeros_like(tau)
        acts = [True] * nb if active is None else list(active)
        for b, n_act in enumerate(_build.slot_ints(n_actual, nb)):
            if acts[b]:
                out[b] = pheromone_update_tours_plain(tau[b], tours[b], w[b],
                                                      rho, n_act)
        return out
    from ..core import pheromone as _ph
    f, t = _ph.tour_edges(tours, n_actual)
    frm = f.reshape(-1).to(torch.int32)
    to = t.reshape(-1).to(torch.int32)
    wrep = _ph.edge_weights(tours, w, n_actual)
    return pheromone_update_plain(tau, torch.cat([frm, to]),
                                  torch.cat([to, frm]),
                                  torch.cat([wrep, wrep]), rho)


def pheromone_update_tours(tau: torch.Tensor, tours: torch.Tensor,
                           w: torch.Tensor, rho: float,
                           n_actual=None,
                           active: Optional[Sequence[bool]] = None
                           ) -> torch.Tensor:
    """Launch the tours-driven kernel on CUDA tensors; raises on anything
    else.  An instance whose tours are all permutations of 0..n-1 takes the
    row-owner path; one with a tour that repeats a city (construction over
    an int8 store can emit one) takes the kernel's exact path, slower and
    as bitwise the plain version.

    The instance axis: a (B, n, n) tau updates B instances in one launch,
    tours (B, m, n) and w (B, m) with it, ``n_actual`` a host int or a (B,)
    int32 tensor on the card whose values the caller has checked to lie in
    [1, n], ``active`` B host flags (None: all).  Each instance is bitwise
    its own single launch; an inactive one is not touched and its plane of
    the result is left unwritten.  ``launches`` counts launches,
    ``slot_launches`` the instances they updated."""
    lead = tuple(tau.shape[:-2])
    if len(lead) > 1:
        raise ValueError("pheromone_update_tours: tau must be (n, n) or "
                         "(B, n, n)")
    nb = lead[0] if lead else 1
    n = tau.shape[-1]
    dev = tau.device
    _build.require("pheromone_update_tours tau", tau, torch.float32,
                   lead + (n, n))
    m = tours.shape[-2]
    _build.require("pheromone_update_tours tours", tours, torch.int32,
                   lead + (m, n), dev)
    _build.require("pheromone_update_tours w", w, torch.float32, lead + (m,),
                   dev)
    # a (B,) tensor is read on the card only: the caller has checked its
    # values (colony_step_batch does); the kernel skips one out of [1, n]
    n_eff, n_eff_ptr = _build.n_actual_arg("pheromone_update_tours",
                                           n_actual, nb, n, dev)
    flags, updated = _build.active_flags(active, nb, dev)
    # the neighbour table, then one flag per instance (the kernel clears)
    nbr = torch.empty(nb * n * m * 2 + nb, dtype=torch.int32, device=dev)
    out = torch.empty_like(tau)
    _build.launch("pheromone_update_tours", dev, tau.data_ptr(),
                  tours.data_ptr(), w.data_ptr(), nbr.data_ptr(),
                  out.data_ptr(), nb, n, m, n_eff, n_eff_ptr,
                  None if flags is None else flags.data_ptr(), _decay(rho))
    _build.count(pheromone_update_tours, updated)
    return out


pheromone_update_tours.launches = 0
pheromone_update_tours.slot_launches = 0
