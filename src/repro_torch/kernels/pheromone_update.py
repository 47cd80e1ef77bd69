"""CUDA kernel: fused pheromone evaporation + deposit over an edge stream.

Replaces ``repro/kernels/pheromone_update.py::pheromone_update``
(``_update_kernel``, ``pallas_call`` at pheromone_update.py:94).  Source:
``csrc/pheromone_update.cu``.

Computes ``out = (1 - rho) * tau + sum_e w_e [frm_e = i][to_e = j]`` over
a directed-edge stream; endpoints outside the (n0, n1) matrix (the -1
padding) deposit nothing, and tau may be rectangular (an island's column
shard).  The Pallas kernel reduces one-hot slabs on the MXU per output
tile; on the H100 the paper's own winning version is native: pass 1
evaporates every cell, pass 2 runs one thread per edge doing an
``atomicAdd``.

Bound on the H100: bytes.  8 per cell (read tau, write out) plus 12 per
edge (frm, to, w): with E = 2 m n at n = m = 1002, about 32 MB, 9.6 us at
3.35 TB/s.  The atomics land on n^2 distinct addresses with few
collisions, so they do not serialise.

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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    pheromone_update.launches += 1
    return out


pheromone_update.launches = 0


def pheromone_update_tours_plain(tau: torch.Tensor, tours: torch.Tensor,
                                 w: torch.Tensor, rho: float,
                                 n_actual: Optional[int] = None
                                 ) -> torch.Tensor:
    """tau (n, n); tours (m, n) closed tours; w (m,) per-ant weights ->
    new tau.  The edge stream of ``core.pheromone.tour_edges`` /
    ``edge_weights`` (closing edge at n_actual - 1, phantom-tail edges at
    weight 0), each undirected edge in both directions, forward edges
    first, through ``pheromone_update_plain``."""
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
                           n_actual: Optional[int] = None) -> torch.Tensor:
    """Launch the tours-driven kernel on CUDA tensors; raises on anything
    else.  Every row of ``tours`` must be a permutation of 0..n-1, as tour
    construction emits them."""
    n = tau.shape[0]
    dev = tau.device
    _build.require("pheromone_update_tours tau", tau, torch.float32, (n, n))
    m = tours.shape[0]
    _build.require("pheromone_update_tours tours", tours, torch.int32,
                   (m, n), dev)
    _build.require("pheromone_update_tours w", w, torch.float32, (m,), dev)
    n_eff = n if n_actual is None else int(n_actual)
    if not 1 <= n_eff <= n:
        raise ValueError(f"pheromone_update_tours: n_actual {n_actual} not "
                         f"in [1, {n}]")
    nbr = torch.empty((n, m, 2), dtype=torch.int32, device=dev)
    out = torch.empty_like(tau)
    _build.launch("pheromone_update_tours", dev, tau.data_ptr(),
                  tours.data_ptr(), w.data_ptr(), nbr.data_ptr(),
                  out.data_ptr(), n, m, n_eff, _decay(rho))
    pheromone_update_tours.launches += 1
    return out


pheromone_update_tours.launches = 0
