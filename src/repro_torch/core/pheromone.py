"""Pheromone update (paper §IV.B, Tables III/IV), the PyTorch port of
``repro.core.pheromone``.

The reference's deposit ladder, mirroring the paper's kernel versions:

- ``scatter``     the paper's winning atomic version: a scatter-add of
                  ``1/C^k`` along each ant's tour edges, then ``d + d.T``;
- ``reduction``   the paper's Reduction version: each edge canonicalised to
                  (lo, hi), half the scatters, then mirrored;
- ``s2g``         scatter-to-gather (paper Fig. 3): every cell gathers over
                  every tour edge, O(n^2 * m * n) work on purpose (claim C4);
- ``s2g_tiled``   the same in the paper's tiles (row x column blocks);
- ``onehot``      the reference's TPU deposit, a one-hot matmul per chunk of
                  ants.  Its result is ported, not its idiom: each chunk is
                  scattered with ``index_add_`` and added to the running sum
                  in the reference's chunk order.

``scatter``, ``reduction`` and ``onehot`` scatter with ``index_add_`` over
flat indices, which on the CPU sums in index order exactly as XLA's CPU
scatter-add does (``index_put_`` with ``accumulate=True`` does not).  On
CUDA ``index_add_`` uses atomics, so a cell with several deposits sums in
another order there: ulp-close.  A single deposit (one tour) is bitwise
in every strategy: each cell then receives at most one term.

``update`` rounds ``(1 - rho) * tau + deposit`` once, as the reference's
fused multiply-add does.  The kernel route's fused update lives in
``kernels/pheromone_update.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import device as _device
from . import floatops, tsp

NActual = Union[int, None]

STRATEGIES = ("scatter", "reduction", "s2g", "s2g_tiled", "onehot")


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


def deposit_s2g(n: int, tours: torch.Tensor, w: torch.Tensor,
                row_tile: int = 0, col_tile: int = 0,
                n_actual: NActual = None) -> torch.Tensor:
    """Scatter-to-gather: cell (i, j) gathers over all m*n edges (paper
    Fig. 3), in the reference's row x column blocks (``row_tile`` /
    ``col_tile`` 0: 64, or n when smaller).  A block is the product of its
    rows' weighted membership masks (bi, E) and its columns' masks
    (bj, E), a ``torch.matmul`` in full float32: on the card it raises if
    TF32 is enabled rather than change the precision (the default is
    full float32).  Work is O(n^2 * m * n) whatever the tiles.  Phantom
    edges of a padded tour carry weight 0; the closing edge wraps at
    ``n_actual - 1``."""
    _device.check_full_fp32(tours.device, "deposit_s2g")
    f, t = tour_edges(tours, n_actual)
    bi = row_tile or min(n, 64)
    bj = col_tile or min(n, 64)
    ni = -(-n // bi) * bi
    nj = -(-n // bj) * bj
    fr = f.reshape(-1)
    tr = t.reshape(-1)
    we = edge_weights(tours, w, n_actual)
    dev = tours.device
    d = torch.empty((ni, nj), dtype=torch.float32, device=dev)
    for i0 in range(0, ni, bi):
        rows = torch.arange(i0, i0 + bi, device=dev)
        mi = (fr[None, :] == rows[:, None]).to(torch.float32) * we  # (bi, E)
        for j0 in range(0, nj, bj):
            cols = torch.arange(j0, j0 + bj, device=dev)
            mj = (tr[None, :] == cols[:, None]).to(torch.float32)   # (bj, E)
            d[i0:i0 + bi, j0:j0 + bj] = mi @ mj.T
    d = d[:n, :n]
    return d + d.T


def deposit_onehot(n: int, tours: torch.Tensor, w: torch.Tensor,
                   chunk: int = 8, n_actual: NActual = None) -> torch.Tensor:
    """The reference's one-hot deposit's result: ants in chunks of
    ``chunk`` (the last chunk zero-padded), each chunk's deposit scattered
    with ``index_add_`` and added to the running sum in chunk order, then
    ``d + d.T``."""
    f, t = tour_edges(tours, n_actual)
    m, ns = f.shape
    we = edge_weights(tours, w, n_actual).reshape(m, ns)
    c = min(chunk, m)
    acc = torch.zeros((n, n), dtype=torch.float32, device=tours.device)
    for a0 in range(0, m, c):
        acc = acc + _scatter_add(n, f[a0:a0 + c], t[a0:a0 + c],
                                 we[a0:a0 + c])
    return acc + acc.T


def deposit(n: int, tours: torch.Tensor, w: torch.Tensor,
            strategy: str = "scatter", tile: int = 64,
            n_actual: NActual = None) -> torch.Tensor:
    if strategy == "scatter":
        return deposit_scatter(n, tours, w, n_actual=n_actual)
    if strategy == "reduction":
        return deposit_reduction(n, tours, w, n_actual=n_actual)
    if strategy == "s2g":
        return deposit_s2g(n, tours, w, 0, 0, n_actual)
    if strategy == "s2g_tiled":
        return deposit_s2g(n, tours, w, tile, tile, n_actual)
    if strategy == "onehot":
        return deposit_onehot(n, tours, w, n_actual=n_actual)
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
