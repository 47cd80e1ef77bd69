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
read and zero them all.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import choice_info as _ci
from . import fused_select as _fs
from . import pheromone_update as _pu
from . import tour_select as _ts

# name -> the launching wrapper that carries the count.
KERNELS = {
    "fused_select": _fs.fused_select,
    "pheromone_update": _pu.pheromone_update,
    "choice_info": _ci.choice_info,
    "tour_select": _ts.tour_select,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _plain(t: torch.Tensor) -> bool:
    """The plain version serves CPU tensors, and only those."""
    return t.device.type == "cpu"


class UnsupportedKernelRoute(NotImplementedError):
    """A config/problem combination the kernels genuinely cannot serve."""


def check_kernel_route(masked: bool = False, hyper: bool = False,
                       tau_dtype: str = "fp32") -> None:
    """Validate that the kernel route supports this problem shape.

    The single typed rejection point: every combination the kernels
    cannot serve raises ``UnsupportedKernelRoute`` with one actionable
    line here, up front.

    - masked (padded) instances: supported by every kernel;
    - per-instance ``Hyper`` operands: unsupported (kernel exponents are
      static);
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
        raise UnsupportedKernelRoute(
            "use_pallas=True cannot serve per-instance Hyper operands: "
            "kernel alpha/beta are static compile-time parameters, but "
            "Hyper carries traced per-instance exponents. Run the "
            "pure-JAX route (use_pallas=False) for per-instance "
            "hyperparameters, or drop Problem.hyper.")


def choice_info(tau: torch.Tensor, eta: torch.Tensor, alpha: float = 1.0,
                beta: float = 2.0,
                n_actual: Optional[int] = None) -> torch.Tensor:
    if _plain(tau):
        return _ci.choice_info_plain(tau, eta, alpha, beta, n_actual)
    return _ci.choice_info(tau, eta, alpha, beta, n_actual)


def tour_select(rows: torch.Tensor, visited: torch.Tensor,
                rand: torch.Tensor, mode: str = "iroulette",
                n_actual: Optional[int] = None) -> torch.Tensor:
    if _plain(rows):
        return _ts.tour_select_plain(rows, visited, rand, mode, n_actual)
    return _ts.tour_select(rows, visited, rand, mode, n_actual)


def fused_select(tau: torch.Tensor, eta: torch.Tensor, cur: torch.Tensor,
                 visited: torch.Tensor, rand: torch.Tensor,
                 alpha: float = 1.0, beta: float = 2.0,
                 n_actual: Optional[int] = None,
                 mode: str = "iroulette") -> torch.Tensor:
    """Fused construction step: row gather + tau^a*eta^b + mask + select,
    without materialising the (m, n) weight matrix."""
    if _plain(tau):
        return _fs.fused_select_plain(tau, eta, cur, visited, rand, alpha,
                                      beta, n_actual, mode)
    return _fs.fused_select(tau, eta, cur, visited, rand, alpha, beta,
                            n_actual, mode)


def pheromone_update(tau: torch.Tensor, tours: torch.Tensor, w: torch.Tensor,
                     rho: float, n_actual: Optional[int] = None
                     ) -> torch.Tensor:
    """Symmetric fused update from (m, n) tours + (m,) weights.

    The edge stream is built with ``core.pheromone.tour_edges`` /
    ``edge_weights`` (closing edge at n_actual-1, phantom-tail edges at
    weight 0), each undirected edge in both directions.
    """
    from ..core import pheromone as _ph
    f, t = _ph.tour_edges(tours, n_actual)
    frm = f.reshape(-1).to(torch.int32)
    to = t.reshape(-1).to(torch.int32)
    wrep = _ph.edge_weights(tours, w, n_actual)
    return pheromone_update_edges(tau, torch.cat([frm, to]),
                                  torch.cat([to, frm]),
                                  torch.cat([wrep, wrep]), rho)


def pheromone_update_edges(tau: torch.Tensor, frm: torch.Tensor,
                           to: torch.Tensor, w: torch.Tensor,
                           rho: float) -> torch.Tensor:
    if _plain(tau):
        return _pu.pheromone_update_plain(tau, frm, to, w, rho)
    return _pu.pheromone_update(tau, frm, to, w, rho)
