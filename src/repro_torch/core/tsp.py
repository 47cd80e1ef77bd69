"""TSP problem substrate: instances, distance matrices, nearest-neighbour lists.

The NumPy half (``TSPInstance``, the generators, the TSPLIB parser,
``pad_instance``, ``nearest_neighbour_tour``) is a copy of the reference's
``repro.core.tsp``; the tensor half (``nn_lists``, ``edge_sum``,
``tour_length``, ``heuristic_matrix``) is its PyTorch port, bitwise equal
on the CPU.

TSPLIB conventions are followed for distance rounding (EUC_2D uses
nint(sqrt), ATT uses the pseudo-Euclidean ceiling rule) so tour lengths are
comparable with published optima when real instances are loaded from files.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Union

import numpy as np
import torch

from . import floatops

NActual = Union[int, None]


@dataclasses.dataclass(frozen=True)
class TSPInstance:
    """A (symmetric) TSP instance.

    coords: (n, 2) float64 city coordinates, or None if dist_matrix given.
    edge_weight_type: TSPLIB distance function name.
    """

    name: str
    coords: Optional[np.ndarray] = None
    edge_weight_type: str = "EUC_2D"
    dist_matrix: Optional[np.ndarray] = None
    known_optimum: Optional[float] = None

    @property
    def n(self) -> int:
        if self.coords is not None:
            return int(self.coords.shape[0])
        assert self.dist_matrix is not None
        return int(self.dist_matrix.shape[0])

    def distances(self) -> np.ndarray:
        """Dense (n, n) float32 distance matrix with TSPLIB rounding."""
        if self.dist_matrix is not None:
            return np.asarray(self.dist_matrix, dtype=np.float32)
        assert self.coords is not None
        xy = self.coords.astype(np.float64)
        d = pairwise_distances(xy, xy, self.edge_weight_type)
        np.fill_diagonal(d, 0.0)
        return d.astype(np.float32)


def pairwise_distances(xy_a: np.ndarray, xy_b: np.ndarray,
                       edge_weight_type: str) -> np.ndarray:
    """(a, b) float64 TSPLIB-rounded distances between two coordinate sets.

    The single source of the rounding rules: ``TSPInstance.distances`` runs
    the full (n, n) matrix through it, and the sparse candidate builder
    (repro.sparse.store) runs row *chunks* through it — the same float64
    arithmetic followed by the same float32 cast downstream, so a candidate
    edge's stored distance is bitwise the dense matrix entry.
    """
    xy_a = np.asarray(xy_a, np.float64)
    xy_b = np.asarray(xy_b, np.float64)
    diff = xy_a[:, None, :] - xy_b[None, :, :]
    if edge_weight_type == "EUC_2D":
        return np.rint(np.sqrt((diff**2).sum(-1)))
    if edge_weight_type == "CEIL_2D":
        return np.ceil(np.sqrt((diff**2).sum(-1)))
    if edge_weight_type == "ATT":
        rij = np.sqrt((diff**2).sum(-1) / 10.0)
        tij = np.rint(rij)
        return np.where(tij < rij, tij + 1.0, tij)
    if edge_weight_type == "RAW":  # no rounding (synthetic)
        return np.sqrt((diff**2).sum(-1))
    raise ValueError(f"unsupported edge_weight_type {edge_weight_type}")


def random_instance(n: int, seed: int = 0, box: float = 1000.0) -> TSPInstance:
    """Uniform-random Euclidean instance (synthetic stand-in for TSPLIB)."""
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0.0, box, size=(n, 2))
    return TSPInstance(name=f"rand{n}", coords=coords, edge_weight_type="RAW")


def circle_instance(n: int, radius: float = 1000.0, seed: int = 0) -> TSPInstance:
    """Cities on a circle: the optimal tour is the angular order.

    known_optimum = perimeter of the polygon through sorted angles. Used for
    honest solution-quality validation without shipping TSPLIB data files.
    """
    rng = np.random.RandomState(seed)
    theta = np.sort(rng.uniform(0.0, 2.0 * math.pi, size=n))
    coords = radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    closed = np.concatenate([coords, coords[:1]], axis=0)
    opt = float(np.sqrt(((closed[1:] - closed[:-1]) ** 2).sum(-1)).sum())
    return TSPInstance(
        name=f"circle{n}", coords=coords, edge_weight_type="RAW", known_optimum=opt
    )


def grid_instance(side: int) -> TSPInstance:
    """side x side unit grid; optimum = side*side for even side (boustrophedon)."""
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)
    opt = float(side * side) if side % 2 == 0 else None
    return TSPInstance(
        name=f"grid{side}x{side}", coords=coords, edge_weight_type="RAW",
        known_optimum=opt,
    )


SUPPORTED_EDGE_WEIGHT_TYPES = ("EUC_2D", "CEIL_2D", "ATT", "EXPLICIT")
SUPPORTED_EDGE_WEIGHT_FORMATS = ("FULL_MATRIX", "UPPER_ROW", "LOWER_ROW",
                                 "UPPER_DIAG_ROW", "LOWER_DIAG_ROW")

_SECTION_KEYWORDS = ("NODE_COORD_SECTION", "EDGE_WEIGHT_SECTION",
                     "DISPLAY_DATA_SECTION", "FIXED_EDGES_SECTION",
                     "TOUR_SECTION", "EOF")


def _explicit_matrix(values: list[float], n: int, fmt: str) -> np.ndarray:
    """Assemble a symmetric (n, n) matrix from an EDGE_WEIGHT_SECTION stream."""
    need = {
        "FULL_MATRIX": n * n,
        "UPPER_ROW": n * (n - 1) // 2,
        "LOWER_ROW": n * (n - 1) // 2,
        "UPPER_DIAG_ROW": n * (n + 1) // 2,
        "LOWER_DIAG_ROW": n * (n + 1) // 2,
    }[fmt]
    if len(values) < need:
        raise ValueError(
            f"EDGE_WEIGHT_SECTION has {len(values)} values; "
            f"{fmt} with DIMENSION {n} needs {need}")
    vals = np.asarray(values[:need], dtype=np.float64)
    d = np.zeros((n, n), dtype=np.float64)
    if fmt == "FULL_MATRIX":
        d = vals.reshape(n, n)
    else:
        diag = fmt.endswith("DIAG_ROW")
        upper = fmt.startswith("UPPER")
        iu = (np.triu_indices(n, 0 if diag else 1) if upper
              else np.tril_indices(n, 0 if diag else -1))
        d[iu] = vals
        d = d + d.T - np.diag(np.diag(d))
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def parse_tsplib(text: str, name: str = "tsplib") -> TSPInstance:
    """TSPLIB .tsp parser.

    Supported: NODE_COORD_SECTION instances with EUC_2D / ATT / CEIL_2D
    rounding (the paper's benchmark families, pr1002/pr2392 included) and
    EXPLICIT distance matrices (EDGE_WEIGHT_SECTION in FULL_MATRIX /
    UPPER_ROW / LOWER_ROW / UPPER_DIAG_ROW / LOWER_DIAG_ROW formats).
    DISPLAY_DATA_SECTION blocks (display-only coordinates some EXPLICIT
    instances carry) are skipped.  Anything else is rejected eagerly with
    the exact field that is unsupported, not deep inside a solve.
    """
    ewt = "EUC_2D"
    m = re.search(r"EDGE_WEIGHT_TYPE\s*:\s*([\w_]+)", text)
    if m:
        ewt = m.group(1)
    if ewt not in SUPPORTED_EDGE_WEIGHT_TYPES:
        raise ValueError(
            f"unsupported EDGE_WEIGHT_TYPE {ewt!r}; "
            f"supported: {', '.join(SUPPORTED_EDGE_WEIGHT_TYPES)}")
    nm = re.search(r"NAME\s*:\s*(\S+)", text)
    if nm:
        name = nm.group(1)
    fmt = None
    fm = re.search(r"EDGE_WEIGHT_FORMAT\s*:\s*([\w_]+)", text)
    if fm:
        fmt = fm.group(1)
    dim = None
    dm = re.search(r"DIMENSION\s*:?\s*(\d+)", text)
    if dm:
        dim = int(dm.group(1))

    coords: list[tuple[float, float]] = []
    weights: list[float] = []
    section = None
    for ln in text.splitlines():
        s = ln.strip()
        if not s:
            continue
        head = s.split()[0].rstrip(":")
        if head in _SECTION_KEYWORDS:
            section = head
            if section == "EOF":
                break
            continue
        if section == "NODE_COORD_SECTION":
            parts = s.split()
            coords.append((float(parts[1]), float(parts[2])))
        elif section == "EDGE_WEIGHT_SECTION":
            weights.extend(float(v) for v in s.split())
        # DISPLAY_DATA_SECTION / other sections: skipped

    if ewt == "EXPLICIT":
        if fmt is None:
            raise ValueError(
                "EDGE_WEIGHT_TYPE EXPLICIT needs an EDGE_WEIGHT_FORMAT field")
        if fmt not in SUPPORTED_EDGE_WEIGHT_FORMATS:
            raise ValueError(
                f"unsupported EDGE_WEIGHT_FORMAT {fmt!r}; supported: "
                f"{', '.join(SUPPORTED_EDGE_WEIGHT_FORMATS)}")
        if not weights:
            raise ValueError("EXPLICIT instance has no EDGE_WEIGHT_SECTION")
        if dim is None:
            raise ValueError("EXPLICIT instance has no DIMENSION field")
        return TSPInstance(name=name,
                           dist_matrix=_explicit_matrix(weights, dim, fmt),
                           edge_weight_type="EXPLICIT")

    if not coords:
        raise ValueError("no NODE_COORD_SECTION found")
    if dim is not None and len(coords) != dim:
        raise ValueError(
            f"NODE_COORD_SECTION has {len(coords)} rows, DIMENSION says {dim}")
    return TSPInstance(name=name, coords=np.asarray(coords), edge_weight_type=ewt)


def load_tsplib(path) -> TSPInstance:
    """Parse a .tsp file from disk (fetch-free fixture path)."""
    import os
    with open(path) as f:
        return parse_tsplib(f.read(), name=os.path.splitext(
            os.path.basename(path))[0])


def find_tsplib(name: str, dirs=("examples", ".")) -> Optional[TSPInstance]:
    """Look for ``<name>.tsp`` under the given directories (repo root first).

    The fixture path for paper-scale instances: drop e.g. ``pr2392.tsp``
    into ``examples/`` and benchmarks pick it up — no network fetch, no
    data files shipped in the repo.  Returns None when absent so callers
    can fall back to synthetic instances of the same size.
    """
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for d in dirs:
        for base in (d, os.path.join(root, d)):
            p = os.path.join(base, f"{name}.tsp")
            if os.path.exists(p):
                return load_tsplib(p)
    return None


def pad_instance(instance: TSPInstance, n_pad: int) -> TSPInstance:
    """Pad an instance to ``n_pad`` cities with masked phantom cities.

    Phantom cities (indices >= instance.n) sit at infinite distance from
    every real city and from each other (diagonal stays 0), so their
    heuristic eta = 1/d is exactly 0 and no masked code path can ever
    prefer them.  The solver engine (solver/batch.py) buckets instances by
    padded size so one vmapped program serves many heterogeneous instances;
    DESIGN.md §8 records the masking invariants.
    """
    n = instance.n
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} < instance size {n}")
    if n_pad == n:
        return instance
    d = np.full((n_pad, n_pad), np.inf, dtype=np.float32)
    d[:n, :n] = instance.distances()
    np.fill_diagonal(d, 0.0)
    return TSPInstance(name=instance.name, dist_matrix=d,
                       edge_weight_type=instance.edge_weight_type,
                       known_optimum=instance.known_optimum)


def nn_lists(dist: torch.Tensor, k: int,
             n_actual: NActual = None) -> torch.Tensor:
    """(n, min(k, n-1)) int32 nearest-neighbour lists, self excluded.

    Ties on equal distances break by city index (stable sort).  With
    ``n_actual`` (padded instances) phantom cities never appear in a list;
    surplus positions hold the row's own index, which every selection rule
    masks (the current city is always visited).
    """
    n = dist.shape[0]
    k = max(1, min(k, n - 1))
    big = torch.finfo(dist.dtype).max
    d = dist + torch.eye(n, dtype=dist.dtype, device=dist.device) * big
    idx = torch.argsort(d, dim=-1, stable=True)[:, :k].to(torch.int32)
    if n_actual is not None:
        self_idx = torch.arange(n, dtype=torch.int32,
                                device=dist.device)[:, None]
        idx = torch.where((idx < n_actual) & (self_idx < n_actual), idx,
                          self_idx)
    return idx


def edge_sum(d: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by explicit pairwise halving (zero-padded at
    odd widths): the reference's association order, on which every bitwise
    tour-length contract rests."""
    while d.shape[-1] > 1:
        if d.shape[-1] % 2:
            d = torch.cat([d, d.new_zeros(d.shape[:-1] + (1,))], dim=-1)
        d = d[..., 0::2] + d[..., 1::2]
    return d[..., 0]


def tour_length(dist: torch.Tensor, tour: torch.Tensor,
                n_actual: NActual = None) -> torch.Tensor:
    """Closed-tour length; tour (..., n) int city permutation.

    With ``n_actual`` the real cities occupy positions ``0..n_actual-1``:
    the closing edge runs from position n_actual-1 back to position 0 and
    phantom-tail edges contribute 0 (masked, never multiplied: phantom
    distances are inf).
    """
    tour = tour.long()
    nxt = torch.roll(tour, -1, dims=-1)
    if n_actual is None:
        return edge_sum(dist[tour, nxt])
    idx = torch.arange(tour.shape[-1], device=tour.device)
    nxt = torch.where(idx == n_actual - 1, tour[..., :1], nxt)
    d = dist[tour, nxt]
    return edge_sum(torch.where(idx < n_actual, d, torch.zeros_like(d)))


def heuristic_matrix(dist: torch.Tensor) -> torch.Tensor:
    """eta = 1/d with safe diagonal (paper eq. 1)."""
    eps = floatops.const(1e-10, dist)
    return torch.ones_like(dist) / torch.maximum(dist, eps)


def is_valid_tour(tour: np.ndarray) -> bool:
    tour = np.asarray(tour)
    n = tour.shape[-1]
    return bool((np.sort(tour, axis=-1) == np.arange(n)).all())


def nearest_neighbour_tour(dist: np.ndarray, start: int = 0) -> tuple[np.ndarray, float]:
    """Greedy NN heuristic tour — used for tau0 initialisation (Dorigo &
    Stützle: tau0 = m / C_nn) and as a quality yardstick."""
    dist = np.asarray(dist)
    n = dist.shape[0]
    visited = np.zeros(n, dtype=bool)
    tour = np.empty(n, dtype=np.int32)
    cur = start
    tour[0] = cur
    visited[cur] = True
    for i in range(1, n):
        d = np.where(visited, np.inf, dist[cur])
        cur = int(np.argmin(d))
        tour[i] = cur
        visited[cur] = True
    length = float(dist[tour, np.roll(tour, -1)].sum())
    return tour, length
