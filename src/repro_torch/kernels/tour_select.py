"""CUDA kernel: the paper's Fig. 1 next-city selection over choice rows.

Replaces ``repro/kernels/tour_select.py::tour_select`` (``_select_kernel``,
``pallas_call`` at tour_select.py:103).  Source: ``csrc/tour_select.cu``.

Bound on the H100: bytes.  Per (ant, city) it reads the choice value (4),
the tabu byte (1) and the draw (4): about 9 MB per step at n = m = 1002,
2.7 us at 3.35 TB/s.  It runs n-1 times an iteration, so launch overhead
weighs as much as the bytes.  One block per ant strides over the ant's row
with coalesced reads and ends in one block arg-max that keeps the lowest
index among equal maxima (the reference's first arg-max).

The instance axis (the reference's kernel under ``vmap``): (B, m, n) rows,
tabu bytes and draws are one launch of B * m blocks, each reading its
instance's ``n_actual`` from a (B,) int32 tensor on the card; the blocks
of an instance that is not ``active`` pick city 0 and read nothing.  The
single launch is its B = 1 case.

``tour_select_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.tour_select`` and the yardstick of the kernel on the card
(bitwise in all three modes: the kernel rounds every operation as the
plain version does and uses accurate ``logf``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import floatops, tsp
from . import _build

_NEG_INF = -1e30
MODES = {"iroulette": 0, "gumbel": 1, "greedy": 2}


def mode_code(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(mode)
    return MODES[mode]


def transform(rows: torch.Tensor, mask: torch.Tensor, rand: torch.Tensor,
              mode: str) -> torch.Tensor:
    """Per-city score whose argmax is the selected city (the reference's
    ``tour_select._transform``)."""
    if mode == "iroulette":
        return rows * rand * mask
    if mode == "gumbel":
        g = -torch.log(-torch.log(torch.clamp(rand, 1e-12, 1.0 - 1e-7)))
        valid = (rows > 0) & (mask > 0)
        return torch.where(valid, torch.log(torch.clamp_min(rows, 1e-38)) + g,
                           floatops.const(_NEG_INF, rows))
    if mode == "greedy":
        return torch.where(mask > 0, rows, floatops.const(_NEG_INF, rows))
    raise ValueError(mode)


def selection_mask(visited: torch.Tensor, n_actual,
                   dtype: torch.dtype) -> torch.Tensor:
    """1 where a city may be selected: unvisited and below n_actual (a host
    int, or a (B,) tensor for (B, ..., n) ``visited``)."""
    mask = (visited == 0).to(dtype)
    if n_actual is not None:
        cols = torch.arange(visited.shape[-1], device=visited.device)
        mask = mask * (cols < tsp.per_slot(n_actual, visited.dim())).to(dtype)
    return mask


def tour_select_plain(rows: torch.Tensor, visited: torch.Tensor,
                      rand: torch.Tensor, mode: str = "iroulette",
                      n_actual=None,
                      active: Optional[Sequence[bool]] = None
                      ) -> torch.Tensor:
    """rows/visited/rand (..., m, n) -> (..., m) int32 selected city per
    ant; a (B, m, n) stack takes a (B,) ``n_actual`` and B ``active``
    flags (an inactive instance picks 0)."""
    mask = selection_mask(visited, n_actual, rows.dtype)
    v = transform(rows, mask, rand, mode)
    out = torch.argmax(v, dim=-1).to(torch.int32)
    if active is not None:
        on = torch.tensor(list(active), dtype=torch.bool, device=out.device)
        out = torch.where(on[:, None], out, torch.zeros_like(out))
    return out


def tour_select(rows: torch.Tensor, visited: torch.Tensor,
                rand: torch.Tensor, mode: str = "iroulette",
                n_actual=None,
                active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else.  (m, n)
    operands, or a (B, m, n) stack with ``n_actual`` a host int or a (B,)
    int32 tensor on the card whose values the caller has checked, and
    ``active`` B host flags (None: all).  ``launches`` counts launches,
    ``slot_launches`` the instances they served."""
    code = mode_code(mode)
    lead = tuple(rows.shape[:-2])
    if len(lead) > 1:
        raise ValueError("tour_select: rows must be (m, n) or (B, m, n)")
    nb = lead[0] if lead else 1
    m, n = rows.shape[-2:]
    dev = rows.device
    _build.require("tour_select rows", rows, torch.float32)
    _build.require("tour_select visited", visited,
                   (torch.bool, torch.uint8, torch.int8), rows.shape, dev)
    _build.require("tour_select rand", rand, torch.float32, rows.shape, dev)
    n_act, n_ptr = _build.n_actual_arg("tour_select", n_actual, nb, n, dev)
    flags, served = _build.active_flags(active, nb, dev)
    out = torch.empty(lead + (m,), dtype=torch.int32, device=dev)
    _build.launch("tour_select", dev, rows.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), out.data_ptr(), nb, m, n, code, n_act,
                  n_ptr, None if flags is None else flags.data_ptr())
    _build.count(tour_select, served)
    return out


tour_select.launches = 0
tour_select.slot_launches = 0
