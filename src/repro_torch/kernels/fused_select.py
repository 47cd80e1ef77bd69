"""CUDA kernel: one fused construction step (choice -> select) for m ants.

Replaces ``repro/kernels/fused_select.py::fused_select`` (``_fused_kernel``,
``pallas_call`` at fused_select.py:176): ``fused_select`` launches the
float32 body (K1), ``fused_select_quant`` the same kernel over an int8 or
bfloat16 tau payload, dequantised in registers after the row gather (the
Pallas kernel's ``quant`` epilogue, K6).  Source: ``csrc/fused_select.cu``.

Bound on the H100: bytes.  Per (ant, city) it reads tau and eta of the
ant's current row (4 + 4), the tabu byte (1) and the draw (4): about 13 MB
per step at n = m = 1002, 3.9 us at 3.35 TB/s.  It runs n-1 times an
iteration, so launch overhead weighs as much as the bytes.  The Pallas
kernel gathers rows with one-hot MXU matmuls; here one block per ant reads
its rows directly, weights, masks and transforms in registers, and ends in
one block arg-max with the lowest-index tie rule.  The (m, n) weight
matrix never exists.

An int8 payload reads 1 byte of tau per (ant, city) instead of 4, and a
bfloat16 payload 2.

``fused_select_plain`` and ``fused_select_quant_plain`` are the same
functions in plain PyTorch: the CPU path of ``ops.fused_select`` and the
yardsticks of the kernel on the card.  The quantised one dequantises the
whole matrix first (the reference's oracle); the per-row scale is constant
along a row, so that multiplies exactly the operands the kernel does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.quant import dequantise_rows
from . import _build
from .choice_info import ipow
from .tour_select import mode_code, tour_select_plain


def fused_select_plain(tau: torch.Tensor, eta: torch.Tensor,
                       cur: torch.Tensor, visited: torch.Tensor,
                       rand: torch.Tensor, alpha: float = 1.0,
                       beta: float = 2.0, n_actual: Optional[int] = None,
                       mode: str = "iroulette") -> torch.Tensor:
    """Gather rows ``cur`` of tau/eta, weight, mask, select -> (m,) int32."""
    c = cur.long()
    rows = ipow(tau[c], alpha) * ipow(eta[c], beta)
    return tour_select_plain(rows, visited, rand, mode, n_actual)


def fused_select_quant_plain(tau_q: torch.Tensor,
                             tau_scale: Optional[torch.Tensor],
                             eta: torch.Tensor, cur: torch.Tensor,
                             visited: torch.Tensor, rand: torch.Tensor,
                             alpha: float = 1.0, beta: float = 2.0,
                             n_actual: Optional[int] = None,
                             mode: str = "iroulette") -> torch.Tensor:
    """Dequantise the whole payload, then ``fused_select_plain``."""
    return fused_select_plain(dequantise_rows(tau_q, tau_scale), eta, cur,
                              visited, rand, alpha, beta, n_actual, mode)


def _check_selection(tau, eta, cur, visited, rand):
    m, n = visited.shape
    dev = tau.device
    if tau.shape[1] != n:
        raise ValueError(f"fused_select: tau has {tau.shape[1]} columns, "
                         f"visited {n}")
    _build.require("fused_select eta", eta, torch.float32, tau.shape, dev)
    _build.require("fused_select cur", cur, torch.int32, (m,), dev)
    _build.require("fused_select visited", visited,
                   (torch.bool, torch.uint8, torch.int8), None, dev)
    _build.require("fused_select rand", rand, torch.float32, (m, n), dev)


def fused_select(tau: torch.Tensor, eta: torch.Tensor, cur: torch.Tensor,
                 visited: torch.Tensor, rand: torch.Tensor,
                 alpha: float = 1.0, beta: float = 2.0,
                 n_actual: Optional[int] = None,
                 mode: str = "iroulette") -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else.

    tau/eta (R, n); cur (m,) int32 in [0, R); visited/rand (m, n).
    """
    code = mode_code(mode)
    m, n = visited.shape
    dev = tau.device
    _build.require("fused_select tau", tau, torch.float32)
    _check_selection(tau, eta, cur, visited, rand)
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("fused_select", dev, tau.data_ptr(), eta.data_ptr(),
                  tau.shape[0], cur.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), out.data_ptr(), m, n, float(alpha),
                  float(beta), code, n_act)
    fused_select.launches += 1
    return out


fused_select.launches = 0


def fused_select_quant(tau_q: torch.Tensor, tau_scale: Optional[torch.Tensor],
                       eta: torch.Tensor, cur: torch.Tensor,
                       visited: torch.Tensor, rand: torch.Tensor,
                       alpha: float = 1.0, beta: float = 2.0,
                       n_actual: Optional[int] = None,
                       mode: str = "iroulette") -> torch.Tensor:
    """Launch the kernel over an int8 (with its (R, 1) float32
    ``tau_scale``) or bfloat16 payload on CUDA tensors; raises on anything
    else."""
    code = mode_code(mode)
    m, n = visited.shape
    dev = tau_q.device
    _build.require("fused_select_quant tau", tau_q,
                   (torch.int8, torch.bfloat16))
    _check_selection(tau_q, eta, cur, visited, rand)
    scale_ptr = None
    if tau_q.dtype == torch.int8:
        if tau_scale is None:
            raise ValueError("fused_select_quant: an int8 payload needs its "
                             "per-row scale")
        _build.require("fused_select_quant scale", tau_scale, torch.float32,
                       (tau_q.shape[0], 1), dev)
        scale_ptr = tau_scale.data_ptr()
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("fused_select_quant", dev, tau_q.data_ptr(),
                  1 if tau_q.dtype == torch.int8 else 2, scale_ptr,
                  eta.data_ptr(), tau_q.shape[0], cur.data_ptr(),
                  visited.data_ptr(), rand.data_ptr(), out.data_ptr(), m, n,
                  float(alpha), float(beta), code, n_act)
    fused_select_quant.launches += 1
    return out


fused_select_quant.launches = 0
