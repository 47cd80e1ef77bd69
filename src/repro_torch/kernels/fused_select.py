"""CUDA kernel: one fused construction step (choice -> select) for m ants.

Replaces ``repro/kernels/fused_select.py::fused_select`` (``_fused_kernel``,
``pallas_call`` at fused_select.py:176), fp32 body.  The int8/bf16 tau
epilogue is not ported yet (ROADMAP queue 2, K6).  Source:
``csrc/fused_select.cu``.

Bound on the H100: bytes.  Per (ant, city) it reads tau and eta of the
ant's current row (4 + 4), the tabu byte (1) and the draw (4): about 13 MB
per step at n = m = 1002, 3.9 us at 3.35 TB/s.  It runs n-1 times an
iteration, so launch overhead weighs as much as the bytes.  The Pallas
kernel gathers rows with one-hot MXU matmuls; here one block per ant reads
its rows directly, weights, masks and transforms in registers, and ends in
one block arg-max with the lowest-index tie rule.  The (m, n) weight
matrix never exists.

``fused_select_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.fused_select`` and the yardstick of the kernel on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

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
    if tau.shape[1] != n:
        raise ValueError(f"fused_select: tau has {tau.shape[1]} columns, "
                         f"visited {n}")
    _build.require("fused_select eta", eta, torch.float32, tau.shape, dev)
    _build.require("fused_select cur", cur, torch.int32, (m,), dev)
    _build.require("fused_select visited", visited,
                   (torch.bool, torch.uint8, torch.int8), None, dev)
    _build.require("fused_select rand", rand, torch.float32, (m, n), dev)
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("fused_select", dev, tau.data_ptr(), eta.data_ptr(),
                  tau.shape[0], cur.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), out.data_ptr(), m, n, float(alpha),
                  float(beta), code, n_act)
    fused_select.launches += 1
    return out


fused_select.launches = 0
