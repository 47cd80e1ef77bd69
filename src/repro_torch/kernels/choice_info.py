"""CUDA kernel: the paper's Choice kernel, choice = tau^alpha * eta^beta.

Replaces ``repro/kernels/choice_info.py::choice_info`` (``_choice_kernel``,
``pallas_call`` at choice_info.py:64).  Source: ``csrc/choice_info.cu``.

Bound on the H100: bytes.  Each cell reads tau and eta and writes one
float, 12 bytes, against at most four multiplies: 12 MB at n = 1002,
about 3.6 us at 3.35 TB/s.  The kernel is one grid-stride pass with 16-byte
vector loads where the row width allows; nothing is reused, so there is
nothing to tile.

The instance axis (the reference's kernel under ``vmap``): a (B, n, n)
stack of tau and eta is one launch, ``n_actual`` a (B,) int32 tensor on the
card, ``active`` B host flags; an inactive instance costs no work and its
plane of the result is left unwritten.  The single launch is its B = 1
case.

``choice_info_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.choice_info`` and the yardstick the kernel is held to on the card
(bitwise for integer exponents 1..4; another exponent goes through
``powf`` in the kernel and ``torch.pow`` in the plain version).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import tsp
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
                      n_actual=None,
                      active: Optional[Sequence[bool]] = None
                      ) -> torch.Tensor:
    """(..., n0, n1) tau^alpha * eta^beta; rows/cols >= n_actual are 0.
    A (B, n0, n1) stack takes a host int or a (B,) tensor ``n_actual``
    and B ``active`` flags (an inactive plane is 0)."""
    n0, n1 = tau.shape[-2:]
    n_act = max(n0, n1) if n_actual is None else \
        tsp.per_slot(n_actual, tau.dim())
    out = ipow(tau, alpha) * ipow(eta, beta)
    rows = torch.arange(n0, device=tau.device)[:, None] < n_act
    cols = torch.arange(n1, device=tau.device)[None, :] < n_act
    keep = rows & cols
    if active is not None:
        on = torch.tensor(list(active), dtype=torch.bool, device=tau.device)
        keep = keep & on[:, None, None]
    return torch.where(keep, out, torch.zeros_like(out))


def choice_info(tau: torch.Tensor, eta: torch.Tensor, alpha: float = 1.0,
                beta: float = 2.0, n_actual=None,
                active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else.  An
    (n0, n1) matrix, or a (B, n0, n1) stack with ``n_actual`` a host int or
    a (B,) int32 tensor on the card whose values the caller has checked,
    ``active`` B host flags (None: all).  ``launches`` counts launches,
    ``slot_launches`` the instances they computed."""
    lead = tuple(tau.shape[:-2])
    if len(lead) > 1:
        raise ValueError("choice_info: tau must be (n0, n1) or (B, n0, n1)")
    nb = lead[0] if lead else 1
    n0, n1 = tau.shape[-2:]
    _build.require("choice_info tau", tau, torch.float32)
    _build.require("choice_info eta", eta, torch.float32, tau.shape,
                   tau.device)
    n_act, n_ptr = _build.n_actual_arg("choice_info", n_actual, nb,
                                       max(n0, n1), tau.device)
    flags, computed = _build.active_flags(active, nb, tau.device)
    out = torch.empty_like(tau)
    _build.launch("choice_info", tau.device, tau.data_ptr(), eta.data_ptr(),
                  out.data_ptr(), nb, n0, n1, float(alpha), float(beta),
                  n_act, n_ptr, None if flags is None else flags.data_ptr())
    _build.count(choice_info, computed)
    return out


choice_info.launches = 0
choice_info.slot_launches = 0
