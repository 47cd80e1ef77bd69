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
"""
from __future__ import annotations

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
