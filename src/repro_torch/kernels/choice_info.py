"""CUDA kernel: the paper's Choice kernel, choice = tau^alpha * eta^beta.

Replaces ``repro/kernels/choice_info.py::choice_info`` (``_choice_kernel``,
``pallas_call`` at choice_info.py:64).  Source: ``csrc/choice_info.cu``.

Bound on the H100: bytes.  Each cell reads tau and eta and writes one
float, 12 bytes, against at most four multiplies: 12 MB at n = 1002,
about 3.6 us at 3.35 TB/s.  The kernel is one grid-stride pass with 16-byte
vector loads where the row width allows; nothing is reused, so there is
nothing to tile.

``choice_info_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.choice_info`` and the yardstick the kernel is held to on the card
(bitwise for integer exponents 1..4; another exponent goes through
``powf`` in the kernel and ``torch.pow`` in the plain version).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def ipow(x: torch.Tensor, p: float) -> torch.Tensor:
    """x^p with the reference's static integer folding (``_ipow``)."""
    if p == 1.0:
        return x
    if float(p).is_integer() and 0 < int(p) <= 4:
        y = x
        for _ in range(int(p) - 1):
            y = y * x
        return y
    return x ** p


def choice_info_plain(tau: torch.Tensor, eta: torch.Tensor,
                      alpha: float = 1.0, beta: float = 2.0,
                      n_actual: Optional[int] = None) -> torch.Tensor:
    """(n0, n1) tau^alpha * eta^beta; rows/cols >= n_actual are 0."""
    n0, n1 = tau.shape
    n_act = max(n0, n1) if n_actual is None else n_actual
    out = ipow(tau, alpha) * ipow(eta, beta)
    rows = torch.arange(n0, device=tau.device)[:, None] < n_act
    cols = torch.arange(n1, device=tau.device)[None, :] < n_act
    return torch.where(rows & cols, out, torch.zeros_like(out))


def choice_info(tau: torch.Tensor, eta: torch.Tensor, alpha: float = 1.0,
                beta: float = 2.0,
                n_actual: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    n0, n1 = tau.shape
    _build.require("choice_info tau", tau, torch.float32)
    _build.require("choice_info eta", eta, torch.float32, tau.shape,
                   tau.device)
    n_act = max(n0, n1) if n_actual is None else int(n_actual)
    out = torch.empty_like(tau)
    _build.launch("choice_info", tau.device, tau.data_ptr(), eta.data_ptr(),
                  out.data_ptr(), n0, n1, float(alpha), float(beta), n_act)
    choice_info.launches += 1
    return out


choice_info.launches = 0
