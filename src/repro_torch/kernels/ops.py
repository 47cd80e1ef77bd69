"""Public wrappers around the CUDA kernels.

On a CPU tensor a wrapper calls its kernel's plain PyTorch version; on a
CUDA tensor it launches the kernel or raises -- there is no fallback.
Every wrapper is mask-aware: ``n_actual`` (host int, the real-city count
of a padded instance) threads through to the kernels, where phantom
cities contribute exactly-zero weight, deposit or a -1e30 score.

``check_kernel_route`` and ``UnsupportedKernelRoute`` are the reference's
single typed rejection point, with the reference's messages.

Each kernel wrapper counts its launches in a plain integer attribute
(``fused_select.launches`` ...); ``launch_counts``/``reset_launch_counts``
read and zero them all.  The launchers that take a leading instance axis
(the two dense walks, the tours-driven update, the sparse walk, the
Choice kernel and the selection) also count the instances their launches
served (``slot_launches``, read by ``slot_launch_counts``).

The dense walk, the tours-driven update and the Choice kernel take that
instance axis as a (B, n, n) stack of instances in one launch, the
selection as (B, m, n) rows and the sparse walk as (B, n, k) pages;
``n_actual`` a (B,) int32 tensor and ``active`` B host flags (an inactive
instance costs no work).  The 2-opt reduction needs no instance axis: a
stack's moves fold into its (B * m, M) rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import choice_info as _ci
from . import fused_select as _fs
from . import pheromone_update as _pu
from . import sparse_select as _ss
from . import tour_select as _ts
from . import two_opt as _to

# name -> the launching wrapper that carries the count.
KERNELS = {
    "fused_select": _fs.fused_select,
    "fused_select_quant": _fs.fused_select_quant,
    "fused_walk": _fs.fused_walk,
    "fused_walk_quant": _fs.fused_walk_quant,
    "pheromone_update": _pu.pheromone_update,
    "pheromone_update_tours": _pu.pheromone_update_tours,
    "choice_info": _ci.choice_info,
    "tour_select": _ts.tour_select,
    "two_opt_best": _to.two_opt_best,
    "sparse_select": _ss.sparse_select,
    "sparse_select_quant": _ss.sparse_select_quant,
    "sparse_walk": _ss.sparse_walk,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def slot_launch_counts() -> dict:
    """Instances served by the launchers with an instance axis."""
    return {name: fn.slot_launches for name, fn in KERNELS.items()
            if hasattr(fn, "slot_launches")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "slot_launches"):
            fn.slot_launches = 0


def _plain(t: torch.Tensor) -> bool:
    """The plain version serves CPU tensors, and only those."""
    return t.device.type == "cpu"


class UnsupportedKernelRoute(NotImplementedError):
    """A config/problem combination the kernels genuinely cannot serve."""


def check_kernel_route(masked: bool = False, hyper: bool = False,
                       sparse: bool = False,
                       selection: Optional[str] = None,
                       local_search: Optional[str] = None,
                       construction: Optional[str] = None,
                       streaming: bool = False,
                       tau_dtype: str = "fp32", mesh: bool = False) -> None:
    """Validate that the kernel/sparse route supports this problem shape.

    The single typed rejection point: every combination the kernels or
    the sparse representation cannot serve raises
    ``UnsupportedKernelRoute`` with one actionable line here, up front.

    - masked (padded) instances: supported by every kernel and the sparse
      route, except sparse Partial-ACO (its windows index positions of the
      real best tour);
    - per-instance ``Hyper`` operands: unsupported (kernel and sparse
      exponents are static);
    - sparse x roulette (needs a full row's cumsum), sparse x local search
      (dense distance matrix), sparse x another construction, sparse x
      streaming (slot surgery assumes dense (n, n) state buffers), sparse
      x mesh (the placement layer shards dense problems);
    - ``tau_dtype``: 'fp32' | 'bf16' | 'int8', and not quantised together
      with ``Hyper``.
    """
    if tau_dtype not in ("fp32", "bf16", "int8"):
        raise UnsupportedKernelRoute(
            f"unknown tau_dtype {tau_dtype!r}: the quantised pheromone "
            "store supports 'fp32' | 'bf16' | 'int8' (core/quant.py).")
    if hyper and tau_dtype != "fp32":
        raise UnsupportedKernelRoute(
            f"per-instance Hyper operands cannot run over a quantised "
            f"pheromone store (tau_dtype={tau_dtype!r}): the quantised "
            "quality gates are validated per static config only. Drop "
            "Problem.hyper or run tau_dtype='fp32'.")
    if hyper:
        if sparse:
            raise UnsupportedKernelRoute(
                "the sparse route cannot serve per-instance Hyper "
                "operands: sparse programs specialise on static "
                "alpha/beta. Drop the Hyper profiles or run the dense "
                "pure-JAX route (sparse=False, use_pallas=False).")
        raise UnsupportedKernelRoute(
            "use_pallas=True cannot serve per-instance Hyper operands: "
            "kernel alpha/beta are static compile-time parameters, but "
            "Hyper carries traced per-instance exponents. Run the "
            "pure-JAX route (use_pallas=False) for per-instance "
            "hyperparameters, or drop Problem.hyper.")
    if not sparse:
        return
    if selection == "roulette":
        raise UnsupportedKernelRoute(
            "sparse construction cannot serve selection='roulette': "
            "inverse-CDF sampling needs the full choice row's cumsum, "
            "which candidate pages do not hold. Use selection="
            "'iroulette', 'gumbel' or 'greedy', or run sparse=False.")
    if local_search is not None and local_search != "none":
        raise UnsupportedKernelRoute(
            f"sparse route cannot serve local_search={local_search!r}: "
            "2-opt/Or-opt moves evaluate arbitrary city pairs against "
            "the dense (n, n) distance matrix. Set local_search='none' "
            "or run sparse=False.")
    if construction is not None and construction not in ("data_parallel",
                                                         "partial"):
        raise UnsupportedKernelRoute(
            f"sparse route has no construction={construction!r}: the "
            "candidate-page step replaces the dense strategy ladder. Use "
            "construction='data_parallel' (standard) or 'partial' "
            "(Partial-ACO mutation), or run sparse=False.")
    if construction == "partial" and masked:
        raise UnsupportedKernelRoute(
            "sparse Partial-ACO cannot run on padded (masked) instances: "
            "mutation windows index positions of the real best tour. Run "
            "the instance unpadded (solo run_sparse) or use "
            "construction='data_parallel'.")
    if streaming:
        raise UnsupportedKernelRoute(
            "sparse instances are not wired into the streaming pool yet: "
            "slot surgery assumes dense (n, n) ColonyState buffers. Use "
            "the batched sparse engine route (solver.engine."
            "solve_instances with sparse=True) or stream dense.")
    if mesh:
        raise UnsupportedKernelRoute(
            "sparse batches are not wired through mesh sharding yet: the "
            "placement layer shards dense Problem pytrees. Run sparse "
            "batches single-device (mesh=None) or shard dense.")


def choice_info(tau: torch.Tensor, eta: torch.Tensor, alpha: float = 1.0,
                beta: float = 2.0, n_actual=None,
                active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """tau^alpha * eta^beta, rows and columns >= n_actual 0; a (B, n, n)
    stack of instances in one launch (``choice_info.choice_info``)."""
    if _plain(tau):
        return _ci.choice_info_plain(tau, eta, alpha, beta, n_actual, active)
    return _ci.choice_info(tau, eta, alpha, beta, n_actual, active)


def tour_select(rows: torch.Tensor, visited: torch.Tensor,
                rand: torch.Tensor, mode: str = "iroulette",
                n_actual=None,
                active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Fig. 1 selection over (m, n) choice rows; a (B, m, n) stack of
    instances in one launch (``tour_select.tour_select``)."""
    if _plain(rows):
        return _ts.tour_select_plain(rows, visited, rand, mode, n_actual,
                                     active)
    return _ts.tour_select(rows, visited, rand, mode, n_actual, active)


def fused_select(tau: torch.Tensor, eta: torch.Tensor, cur: torch.Tensor,
                 visited: torch.Tensor, rand: torch.Tensor,
                 alpha: float = 1.0, beta: float = 2.0,
                 n_actual: Optional[int] = None,
                 mode: str = "iroulette",
                 tau_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused construction step: row gather + tau^a*eta^b + mask + select,
    without materialising the (m, n) weight matrix.  An int8 or bfloat16
    ``tau`` is a quantised payload (``core/quant.py``), dequantised in the
    kernel after the row gather; ``tau_scale`` is the int8 per-row scale."""
    if tau.dtype in (torch.int8, torch.bfloat16):
        if _plain(tau):
            return _fs.fused_select_quant_plain(tau, tau_scale, eta, cur,
                                                visited, rand, alpha, beta,
                                                n_actual, mode)
        return _fs.fused_select_quant(tau, tau_scale, eta, cur, visited,
                                      rand, alpha, beta, n_actual, mode)
    if _plain(tau):
        return _fs.fused_select_plain(tau, eta, cur, visited, rand, alpha,
                                      beta, n_actual, mode)
    return _fs.fused_select(tau, eta, cur, visited, rand, alpha, beta,
                            n_actual, mode)


def fused_walk(tau: torch.Tensor, eta: torch.Tensor, start: torch.Tensor,
               key: torch.Tensor, alpha: float = 1.0, beta: float = 2.0,
               n_actual: Optional[int] = None, mode: str = "iroulette",
               draw_mode: str = "packed",
               tau_scale: Optional[torch.Tensor] = None,
               visited: Optional[torch.Tensor] = None,
               first_step: int = 1,
               active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The dense fused construction walk: steps first_step .. n-1 of every
    ant (row gather, tau^a * eta^b, the draw of ``fold_in(key, t)``, mask,
    select, tabu update), as (n - first_step, m) int32 cities.  An int8 or
    bfloat16 ``tau`` is a quantised payload; ``tau_scale`` is the int8
    per-row scale.  A (B, n, n) ``tau`` walks a stack of instances
    (``fused_select.fused_walk``)."""
    quantised = tau.dtype in (torch.int8, torch.bfloat16)
    if _plain(tau):
        return _fs.fused_walk_plain(tau, eta, start, key, alpha, beta,
                                    n_actual, mode, draw_mode, tau_scale,
                                    visited, first_step, active=active)
    if quantised:
        return _fs.fused_walk_quant(tau, tau_scale, eta, start, key, alpha,
                                    beta, n_actual, mode, draw_mode, visited,
                                    first_step, active)
    return _fs.fused_walk(tau, eta, start, key, alpha, beta, n_actual, mode,
                          draw_mode, visited, first_step, active)


def pheromone_update(tau: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
                     rho: float, n_actual=None,
                     active: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """Symmetric fused update from (m, n) tours + (m,) weights: the edge
    stream of ``core.pheromone.tour_edges`` / ``edge_weights`` (closing
    edge at n_actual-1, phantom-tail edges at weight 0), each undirected
    edge in both directions.  On the card the tours-driven kernel applies
    it without building the stream.  A (B, n, n) ``tau`` updates a stack
    of instances (``pheromone_update.pheromone_update_tours``)."""
    if _plain(tau):
        return _pu.pheromone_update_tours_plain(tau, tours, w, rho, n_actual,
                                                active)
    return _pu.pheromone_update_tours(tau, tours, w, rho, n_actual, active)


def pheromone_update_edges(tau: torch.Tensor, frm: torch.Tensor,
                           to: torch.Tensor, w: torch.Tensor,
                           rho: float) -> torch.Tensor:
    if _plain(tau):
        return _pu.pheromone_update_plain(tau, frm, to, w, rho)
    return _pu.pheromone_update(tau, frm, to, w, rho)


def two_opt_best(add1: torch.Tensor, add2: torch.Tensor, rem1: torch.Tensor,
                 rem2: torch.Tensor, valid: torch.Tensor, thr: float = 0.0,
                 mode: str = "best") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ant best/first 2-opt move over (m, M) gathered move operands.
    Phantom-touching moves of a padded instance arrive with valid = 0."""
    if _plain(add1):
        return _to.two_opt_best_plain(add1, add2, rem1, rem2, valid, thr,
                                      mode)
    return _to.two_opt_best(add1, add2, rem1, rem2, valid, thr, mode)


def sparse_select(tau_rows: torch.Tensor, eta_rows: torch.Tensor,
                  cand: torch.Tensor, visited: torch.Tensor,
                  rand: torch.Tensor, alpha: float = 1.0, beta: float = 2.0,
                  mode: str = "iroulette",
                  tau_scale: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse candidate-page selection: gather visited/rand at the K
    candidate cities, weight tau^a * eta^b, mask, select, with no (m, n)
    weight tensor.  Returns (pos, have): the winning page position and
    whether a selectable candidate exists (the nearest-unvisited fallback
    trigger).  An int8 or bfloat16 ``tau_rows`` is a quantised page
    payload; ``tau_scale`` is the int8 (m, K) scale."""
    if tau_rows.dtype in (torch.int8, torch.bfloat16):
        if _plain(tau_rows):
            return _ss.sparse_select_quant_plain(tau_rows, tau_scale,
                                                 eta_rows, cand, visited,
                                                 rand, alpha, beta, mode)
        return _ss.sparse_select_quant(tau_rows, tau_scale, eta_rows, cand,
                                       visited, rand, alpha, beta, mode)
    if _plain(tau_rows):
        return _ss.sparse_select_plain(tau_rows, eta_rows, cand, visited,
                                       rand, alpha, beta, mode)
    return _ss.sparse_select(tau_rows, eta_rows, cand, visited, rand, alpha,
                             beta, mode)


def sparse_walk(problem, tau, ovf_city: torch.Tensor, ovf_tau,
                start: torch.Tensor, visited: torch.Tensor,
                keys: torch.Tensor, selection: str = "iroulette",
                alpha: float = 1.0, beta: float = 2.0, ewt: str = "RAW",
                draw_mode: str = "packed", n_actual=None,
                active: Optional[Sequence[bool]] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse kernel route's construction walk, one step per key:
    page gather, draw at the candidates, selection, page-fault fallback
    and tabu update for every ant (``visited`` updated in place).  Returns
    (cities (S, m), edge lengths (S, m), fallback steps per ant (m,)).  A
    (B, n, k) ``problem`` walks a stack of instances
    (``sparse_select.sparse_walk``)."""
    if _plain(start):
        return _ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau, start,
                                     visited, keys, selection, alpha, beta,
                                     ewt, draw_mode, n_actual, active)
    return _ss.sparse_walk(problem, tau, ovf_city, ovf_tau, start, visited,
                           keys, selection, alpha, beta, ewt, draw_mode,
                           n_actual, active)
