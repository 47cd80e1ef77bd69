"""CUDA kernel: the paper's Fig. 1 next-city selection over choice rows.

Replaces ``repro/kernels/tour_select.py::tour_select`` (``_select_kernel``,
``pallas_call`` at tour_select.py:103).  Source: ``csrc/tour_select.cu``.

Bound on the H100: bytes.  Per (ant, city) it reads the choice value (4),
the tabu byte (1) and the draw (4): about 9 MB per step at n = m = 1002,
2.7 us at 3.35 TB/s.  It runs n-1 times an iteration, so launch overhead
weighs as much as the bytes.  One block per ant strides over the ant's row
with coalesced reads and ends in one block arg-max that keeps the lowest
index among equal maxima (the reference's first arg-max).

``tour_select_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.tour_select`` and the yardstick of the kernel on the card
(bitwise in all three modes: the kernel rounds every operation as the
plain version does and uses accurate ``logf``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import floatops
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


def selection_mask(visited: torch.Tensor, n_actual: Optional[int],
                   dtype: torch.dtype) -> torch.Tensor:
    """1 where a city may be selected: unvisited and below n_actual."""
    mask = (visited == 0).to(dtype)
    if n_actual is not None:
        cols = torch.arange(visited.shape[-1], device=visited.device)
        mask = mask * (cols < n_actual).to(dtype)
    return mask


def tour_select_plain(rows: torch.Tensor, visited: torch.Tensor,
                      rand: torch.Tensor, mode: str = "iroulette",
                      n_actual: Optional[int] = None) -> torch.Tensor:
    """rows/visited/rand (m, n) -> (m,) int32 selected city per ant."""
    mask = selection_mask(visited, n_actual, rows.dtype)
    v = transform(rows, mask, rand, mode)
    return torch.argmax(v, dim=-1).to(torch.int32)


def tour_select(rows: torch.Tensor, visited: torch.Tensor,
                rand: torch.Tensor, mode: str = "iroulette",
                n_actual: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    code = mode_code(mode)
    m, n = rows.shape
    dev = rows.device
    _build.require("tour_select rows", rows, torch.float32)
    _build.require("tour_select visited", visited,
                   (torch.bool, torch.uint8, torch.int8), rows.shape, dev)
    _build.require("tour_select rand", rand, torch.float32, rows.shape, dev)
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("tour_select", dev, rows.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), out.data_ptr(), m, n, code, n_act)
    tour_select.launches += 1
    return out


tour_select.launches = 0
