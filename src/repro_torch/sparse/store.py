"""Sparse/paged problem representation: O(n*k) storage, no dense rows.

The PyTorch port of ``repro.sparse.store``.  Every resident tensor is
candidate-list-restricted to (n, k):

- ``SparseProblem``: per-city candidate lists (``cand``, the k nearest
  neighbours by TSPLIB-rounded distance, index tie-break) with distance
  and eta stored only on candidate edges, plus the (n, 2) float32
  coordinates from which any off-list distance is recomputed lazily (the
  "page-fault" path);
- ``SparseColonyState``: pheromone on candidate edges (``tau`` (n, k)), a
  scalar off-list default trail ``tau_def`` and a bounded per-city
  overflow page (``ovf_city``/``ovf_tau``, O slots) for adopted off-list
  edges.

The NumPy builders (``build_candidates``, ``make_sparse_problem``,
``sparse_nearest_neighbour_tour``, ``sparse_initial_tau``) are copies of
the reference's: every stored real candidate value is the dense matrix
entry, bit for bit.  Surplus self-sentinel slots (page positions beyond a
row's n-1 real neighbours, and every phantom row) hold distance 1.0 so
that their eta stays finite; they are always visited-masked.

The lazy distances follow the reference's compiled numbers: inside its
jitted steps XLA rounds ``dx*dx + dy*dy`` once (a fused multiply-add,
``torch.addcmul`` here), and the square root is the correctly rounded one
(``floatops.sqrt``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..core import floatops, quant, tsp

OVF_EMPTY = -1          # ovf_city sentinel: slot not adopted


class SparseProblem(NamedTuple):
    """Device-resident constants for one candidate-list-restricted instance.

    ``n_actual`` follows the port's ``Problem``: None for ordinary
    instances, the host int count of real cities for a padded one (phantom
    cities never appear in a candidate list).  The TSPLIB rounding rule
    (edge_weight_type) travels beside the problem as a string.  A bucket's
    stack (``solver.batch.make_sparse_batch``) holds (B, n, ...) tensors
    and a host tuple of B ``n_actual`` counts.
    """
    coords: torch.Tensor     # (n, 2) float32
    cand: torch.Tensor       # (n, k) int32 candidate ids (self = sentinel)
    cand_dist: torch.Tensor  # (n, k) float32, == dense dist at (i, cand)
    cand_eta: torch.Tensor   # (n, k) float32, == dense eta at (i, cand)
    n_actual: Optional[int] = None

    @property
    def n(self) -> int:
        return int(self.cand.shape[-2])

    @property
    def k(self) -> int:
        return int(self.cand.shape[-1])

    def stacked(self) -> "SparseProblem":
        """This one instance as a stack of one: (1, n, ...) views and a
        1-tuple ``n_actual``."""
        return SparseProblem(*(t[None] for t in self[:4]),
                             n_actual=None if self.n_actual is None
                             else (int(self.n_actual),))

    def slot(self, b: int, n_actual: Optional[int] = None) -> "SparseProblem":
        """Instance ``b`` of a stack: its tensors' [b] (views) and the
        given host ``n_actual``."""
        return SparseProblem(*(t[b] for t in self[:4]), n_actual=n_actual)


TauLike = Union[torch.Tensor, quant.QuantTau]


class SparseColonyState(NamedTuple):
    """Paged pheromone state + the usual best-tracking scalars."""
    tau: TauLike               # (n, k) trail on candidate edges
    tau_def: torch.Tensor      # () off-list default trail
    ovf_city: torch.Tensor     # (n, O) int32 adopted off-list cities (-1)
    ovf_tau: TauLike           # (n, O) adopted off-list trail
    best_tour: torch.Tensor    # (n,) int32
    best_len: torch.Tensor     # () float32
    iteration: torch.Tensor    # () int32
    key: torch.Tensor          # (2,) int64 threefry key


def _pairwise_f32(xy: np.ndarray, rows: np.ndarray, ewt: str) -> np.ndarray:
    """(len(rows), n) float32 distance rows, bitwise == dense matrix rows."""
    d = tsp.pairwise_distances(xy[rows], xy, ewt)
    d[np.arange(len(rows)), rows] = 0.0      # diagonal convention
    return d.astype(np.float32)


def build_candidates(instance: tsp.TSPInstance, k: int,
                     chunk: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(n, k) candidate ids + distances without materialising (n, n).

    Distance rows come in ``chunk``-row blocks; candidates are the k
    nearest by the float32 distance with stable index tie-breaking.  Rows
    with fewer than ``k`` real neighbours fill the surplus positions with
    the row's own index (the always-visited self sentinel).
    """
    if instance.coords is None:
        raise ValueError(
            "sparse representation needs coordinates; EXPLICIT "
            "distance-matrix instances must run the dense route")
    xy = np.asarray(instance.coords, np.float64)
    n = instance.n
    kk = max(1, min(k, n - 1))
    cand = np.empty((n, k), np.int32)
    cdist = np.empty((n, k), np.float32)
    for lo in range(0, n, chunk):
        rows = np.arange(lo, min(lo + chunk, n))
        d = _pairwise_f32(xy, rows, instance.edge_weight_type)
        d[np.arange(len(rows)), rows] = np.inf      # exclude self
        order = np.argsort(d, axis=-1, kind="stable")[:, :kk]
        cand[rows, :kk] = order
        cdist[rows, :kk] = np.take_along_axis(d, order, axis=-1)
        if kk < k:                                   # surplus -> self sentinel
            cand[rows, kk:] = rows[:, None]
            cdist[rows, kk:] = 1.0
    return cand, cdist


def make_sparse_problem(instance: tsp.TSPInstance, k: int,
                        n_pad: Optional[int] = None, chunk: int = 256,
                        device: _device.DeviceLike = None) -> SparseProblem:
    """Build the O(n*k) problem pages, optionally padded to ``n_pad``.

    Phantom rows (>= instance.n) are entirely self-sentinel candidates
    with eta 0; ``n_actual`` is set whenever padding is requested.
    """
    dev = _device.resolve(device)
    n = instance.n
    n_pad = n if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} < instance size {n}")
    cand, cdist = build_candidates(instance, k, chunk)
    eta = (np.float32(1.0) / np.maximum(cdist, np.float32(1e-10))).astype(
        np.float32)
    coords = np.asarray(instance.coords, np.float32)
    if n_pad > n:
        pad_idx = np.arange(n, n_pad, dtype=np.int32)
        cand = np.concatenate(
            [cand, np.broadcast_to(pad_idx[:, None], (n_pad - n, k)).copy()])
        cdist = np.concatenate([cdist, np.ones((n_pad - n, k), np.float32)])
        eta = np.concatenate([eta, np.zeros((n_pad - n, k), np.float32)])
        coords = np.concatenate([coords, np.zeros((n_pad - n, 2), np.float32)])
    return SparseProblem(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (coords, cand, cdist, eta)),
        n_actual=n if n_pad > n else None)


# --------------------------------------------------------------- lazy pages

def _round_ewt(diff: torch.Tensor, ewt: str) -> torch.Tensor:
    dx, dy = diff[..., 0], diff[..., 1]
    sq = torch.addcmul(dx * dx, dy, dy)          # XLA's fused dx*dx + dy*dy
    if ewt == "EUC_2D":
        return torch.round(floatops.sqrt(sq))    # half to even, as rint
    if ewt == "CEIL_2D":
        return torch.ceil(floatops.sqrt(sq))
    if ewt == "ATT":
        rij = floatops.sqrt(sq / floatops.const(10.0, sq))
        tij = torch.round(rij)
        return torch.where(tij < rij, tij + 1.0, tij)
    if ewt == "RAW":
        return floatops.sqrt(sq)
    raise ValueError(f"unsupported edge_weight_type {ewt}")


def flat_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row numbers ``idx`` of a per-city tensor as rows of it flattened
    over its leading axes: (n, c) and a one-instance stack as they are; a
    (B, n, c) stack's (B, ...) ``idx`` shifted into each instance's own
    plane."""
    idx = idx.long()
    if t.dim() == 2 or t.shape[0] == 1:
        return idx
    nb, n = t.shape[:2]
    return idx + torch.arange(nb, device=idx.device).reshape(
        (nb,) + (1,) * (idx.dim() - 1)) * n


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a per-city tensor: (n, c) indexed by any ``idx``;
    a (B, n, c) stack by a (B, ...) ``idx``, each instance's rows from its
    own plane."""
    return t.reshape((-1,) + tuple(t.shape[-1:]))[flat_rows(t, idx)]


def lazy_rows(coords: torch.Tensor, cur: torch.Tensor,
              ewt: str) -> torch.Tensor:
    """(m, n) float32 distances from cities ``cur`` to every city, from
    coordinates: the page-fault path for fallback steps ((B, m, n) over a
    (B, n, 2) stack)."""
    diff = take(coords, cur)[..., :, None, :] - coords.unsqueeze(-3)
    return _round_ewt(diff, ewt)


def lazy_pair(coords: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              ewt: str) -> torch.Tensor:
    """Elementwise float32 distances between city tensors of equal shape
    (of each instance's cities over a (B, n, 2) stack)."""
    return _round_ewt(take(coords, a) - take(coords, b), ewt)


def pair_lookup(problem: SparseProblem, a: torch.Tensor, b: torch.Tensor,
                ewt: str) -> torch.Tensor:
    """Distance of arbitrary city pairs: a candidate-page hit gives the
    stored (dense-bitwise) value, a miss the lazy recompute.  Over a
    stacked problem ``a`` and ``b`` are (B, ...), instance by instance."""
    eq = take(problem.cand, a) == b[..., None]   # (..., k)
    found = eq.any(-1)
    pos = torch.argmax(eq.to(torch.uint8), dim=-1)
    on = torch.gather(take(problem.cand_dist, a), -1, pos[..., None])[..., 0]
    return torch.where(found, on, lazy_pair(problem.coords, a, b, ewt))


def sparse_tour_length(problem: SparseProblem, tours: torch.Tensor,
                       ewt: str, n_actual: Optional[int] = None
                       ) -> torch.Tensor:
    """Closed-tour lengths for (m, n) tours from the sparse pages only,
    with ``tsp.tour_length``'s masking semantics."""
    nxt = torch.roll(tours, -1, dims=-1)
    idx = torch.arange(tours.shape[-1], device=tours.device)
    if n_actual is not None:
        nxt = torch.where(idx == n_actual - 1, tours[..., :1], nxt)
    d = pair_lookup(problem, tours, nxt, ewt)
    if n_actual is not None:
        d = torch.where(idx < n_actual, d, torch.zeros_like(d))
    return tsp.edge_sum(d)


# ----------------------------------------------------------- init / metrics

def sparse_nearest_neighbour_tour(instance: tsp.TSPInstance,
                                  start: int = 0) -> tuple[np.ndarray, float]:
    """Greedy NN tour from coordinate rows (no (n, n) matrix), bitwise the
    dense ``tsp.nearest_neighbour_tour`` result."""
    xy = np.asarray(instance.coords, np.float64)
    n = instance.n
    ewt = instance.edge_weight_type
    visited = np.zeros(n, dtype=bool)
    tour = np.empty(n, dtype=np.int32)
    cur = start
    tour[0] = cur
    visited[cur] = True
    for i in range(1, n):
        row = _pairwise_f32(xy, np.asarray([cur]), ewt)[0]
        cur = int(np.argmin(np.where(visited, np.inf, row)))
        tour[i] = cur
        visited[cur] = True
    # the same float32 edge array and NumPy pairwise .sum() as the dense
    # dist[tour, roll(tour, -1)].sum()
    edges = np.empty(n, np.float32)
    nxt = np.roll(tour, -1)
    for lo in range(0, n, 256):
        hi = min(lo + 256, n)
        h = hi - lo
        edges[lo:hi] = tsp.pairwise_distances(
            xy[tour[lo:hi]], xy[nxt[lo:hi]], ewt
        )[np.arange(h), np.arange(h)].astype(np.float32)
    return tour, float(edges.sum())


def sparse_initial_tau(instance: tsp.TSPInstance, cfg) -> float:
    """tau0 = m/C_nn (AS), 1/(rho C_nn) (MMAS), 1/(n C_nn) (ACS), with C_nn
    from the row-wise NN tour."""
    _, c_nn = sparse_nearest_neighbour_tour(instance)
    n = instance.n
    m = cfg.num_ants(n)
    if cfg.variant == "mmas":
        return 1.0 / (cfg.rho * c_nn)
    if cfg.variant == "acs":
        return 1.0 / (n * c_nn)
    return m / c_nn


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


def resident_bytes(problem: SparseProblem,
                   state: SparseColonyState) -> int:
    """Total device-resident bytes of the sparse representation, counted
    over the port's tensors as they are (its key is two int64 words)."""
    return sum(t.numel() * t.element_size()
               for t in _tensors((tuple(problem), tuple(state))))


def dense_resident_bytes(n: int) -> int:
    """What the dense route keeps resident for one colony: dist + eta +
    tau, three (n, n) float32 tensors."""
    return 3 * n * n * 4


@dataclasses.dataclass(frozen=True)
class SparseBatchMeta:
    """Static facts a sparse bucket shares: one rounding rule and one
    candidate width per batch (``solver.batch.make_sparse_batch`` rejects a
    bucket that mixes rounding rules)."""
    ewt: str
    k: int
    n_pad: int
