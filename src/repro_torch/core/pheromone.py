"""Pheromone update (paper §IV.B), the PyTorch port of ``repro.core.pheromone``.

Two deposit strategies of the reference's ladder are ported:

- ``scatter``     the paper's winning atomic version: a scatter-add of
                  ``1/C^k`` along each ant's tour edges, then ``d + d.T``;
- ``reduction``   the paper's Reduction version: each edge canonicalised to
                  (lo, hi), half the scatters, then mirrored.

Both scatter with ``index_add_`` over flat indices, which on the CPU sums
in index order exactly as XLA's CPU scatter-add does (``index_put_`` with
``accumulate=True`` does not).  On CUDA ``index_add_`` uses atomics, so a
cell with several deposits sums in another order there: ulp-close.

``update`` rounds ``(1 - rho) * tau + deposit`` once, as the reference's
fused multiply-add does.  The kernel route's fused update lives in
``kernels/pheromone_update.py``.  The ``s2g``, ``s2g_tiled`` and ``onehot``
strategies are not ported yet (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import floatops, tsp

NActual = Union[int, None]

STRATEGIES = ("scatter", "reduction")
NOT_PORTED = ("s2g", "s2g_tiled", "onehot")     # ROADMAP queue 1 item 4


def evaporate(tau: torch.Tensor, rho: float) -> torch.Tensor:
    """Eq. 2: tau <- (1 - rho) tau."""
    return floatops.const(1.0 - rho, tau) * tau


def tour_edges(tours: torch.Tensor, n_actual=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Directed edge endpoints (m, n) for closed tours; with ``n_actual``
    the closing edge wraps at position n_actual-1 back to position 0.
    (B, m, n) tours of a stack take a (B,) ``n_actual`` tensor."""
    t = torch.roll(tours, -1, dims=-1)
    if n_actual is not None:
        idx = torch.arange(tours.shape[-1], device=tours.device)
        n_act = tsp.per_slot(n_actual, tours.dim())
        t = torch.where(idx == n_act - 1, tours[..., :1], t)
    return tours, t


def edge_weights(tours: torch.Tensor, w: torch.Tensor,
                 n_actual: NActual = None) -> torch.Tensor:
    """(m*n,) per-edge deposit weights; phantom-tail edges masked to 0.
    (B, m, n) tours of a stack take (B, m) weights and a (B,) ``n_actual``
    tensor and give (B, m*n)."""
    ns = tours.shape[-1]
    wrep = w[..., None].expand(tuple(w.shape) + (ns,))
    if n_actual is not None:
        idx = torch.arange(ns, device=tours.device)
        wrep = torch.where(idx < tsp.per_slot(n_actual, tours.dim()), wrep,
                           torch.zeros_like(wrep))
    return wrep.reshape(tuple(tours.shape[:-2]) + (-1,))


def _scatter_add(n: int, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    flat = rows.reshape(-1).long() * n + cols.reshape(-1).long()
    d = torch.zeros(n * n, dtype=torch.float32, device=vals.device)
    return d.index_add_(0, flat, vals.reshape(-1)).view(n, n)


def deposit_scatter(n: int, tours: torch.Tensor, w: torch.Tensor,
                    symmetric: bool = True,
                    n_actual: NActual = None) -> torch.Tensor:
    """Atomic-analogue scatter-add (paper versions 1/2)."""
    f, t = tour_edges(tours, n_actual)
    d = _scatter_add(n, f, t, edge_weights(tours, w, n_actual))
    return d + d.T if symmetric else d


def deposit_reduction(n: int, tours: torch.Tensor, w: torch.Tensor,
                      n_actual: NActual = None) -> torch.Tensor:
    """Paper's Reduction version: half the scatters via edge canonicalisation."""
    f, t = tour_edges(tours, n_actual)
    upper = _scatter_add(n, torch.minimum(f, t), torch.maximum(f, t),
                         edge_weights(tours, w, n_actual))
    return upper + upper.T


def deposit(n: int, tours: torch.Tensor, w: torch.Tensor,
            strategy: str = "scatter", tile: int = 64,
            n_actual: NActual = None) -> torch.Tensor:
    del tile                      # used by the s2g strategies only
    if strategy == "scatter":
        return deposit_scatter(n, tours, w, n_actual=n_actual)
    if strategy == "reduction":
        return deposit_reduction(n, tours, w, n_actual=n_actual)
    if strategy in NOT_PORTED:
        raise NotImplementedError(
            f"deposit strategy {strategy!r} is not ported yet "
            "(ROADMAP queue 1 item 4); use 'scatter' or 'reduction'")
    raise ValueError(f"unknown deposit strategy {strategy}")


def update(tau: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
           rho: Union[float, torch.Tensor], strategy: str = "scatter",
           tile: int = 64, n_actual: NActual = None) -> torch.Tensor:
    """Full pheromone update: evaporation (eq. 2) + deposit (eq. 3/4),
    ``(1 - rho) * tau + D`` rounded once.  A tensor ``rho`` (a Hyper's
    operand) takes ``1 - rho`` in float32, as a traced operand does."""
    d = deposit(tau.shape[0], tours, w, strategy, tile, n_actual)
    keep = 1.0 - rho if isinstance(rho, torch.Tensor) \
        else floatops.const(1.0 - rho, tau)
    return torch.addcmul(d, keep, tau)


def local_update_acs(tau: torch.Tensor, frm: torch.Tensor, to: torch.Tensor,
                     xi: float, tau0: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ACS local pheromone rule on the just-crossed edges (both directions),
    in the reference's closed form over crossing counts c:
    tau <- (1-xi)^c tau + (1 - (1-xi)^c) tau0.

    The reference's compiler fuses the first product into the sum:
    fma(factor, tau, (1 - factor) * tau0), computed here as one addcmul.
    A (B, n, n) tau of a stack takes (B, E) edges and weights and a (B,)
    tau0; each instance is bitwise its own call (the counts are exact).
    An (n, n) tau is the stack of one.
    """
    if tau.dim() == 2:
        return local_update_acs(tau[None], frm[None], to[None], xi, tau0,
                                None if w is None else w[None])[0]
    nb, n = tau.shape[0], tau.shape[-1]
    ones = torch.ones_like(frm, dtype=tau.dtype) if w is None \
        else w.to(tau.dtype)
    # one scatter over the stack: instance b's cells at b n^2 + i n + j
    base = torch.arange(nb, device=frm.device)[:, None] * n
    flat = ((base + frm.long()) * n + to.long()).reshape(-1)
    counts = torch.zeros(nb * n * n, dtype=torch.float32, device=tau.device)
    counts = counts.index_add_(0, flat, ones.reshape(-1)).view(nb, n, n)
    counts = counts + counts.transpose(-1, -2)
    tau0 = tsp.per_slot(tau0, 3)
    factor = torch.pow(floatops.const(1.0 - xi, tau), counts)
    return torch.addcmul((1.0 - factor) * tau0, factor, tau)
