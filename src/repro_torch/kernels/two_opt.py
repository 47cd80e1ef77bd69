"""CUDA kernel: per-ant 2-opt move reduction (local search).

Replaces ``repro/kernels/two_opt.py::two_opt_best`` (``_delta_kernel``,
``pallas_call`` at two_opt.py:119).  Source: ``csrc/two_opt.cu``.

Over the flattened (m, M) move operands, M = n * k nearest-neighbour
moves per ant, the move delta is ``((add1 + add2) - rem1) - rem2``; moves
with ``valid == 0`` read as 1e30.  ``best`` returns each ant's least delta
and its lowest flat index; ``first`` returns the lowest index with
``delta < -thr`` and its delta, or (1e30, 2**31 - 1) when none improves.

Bound on the H100: bytes.  Each move reads four float32 operands and one
mask byte, 17 bytes: about 512 MB per call at m = n = 1002, k = 30
(M = 30060), 153 us at 3.35 TB/s.  The Pallas kernel walks (8 x 512)
tiles and carries a running (value, index) across the tile axis in its
output block; here one block per ant strides over the ant's M moves with
coalesced reads, keeps a running pair in registers and ends in one block
reduction.  The operand gathers stay outside, in
``core/localsearch._two_opt_operands``, as in the reference.

``two_opt_best_plain`` is the same function in plain PyTorch: the CPU path
of ``ops.two_opt_best`` and the yardstick of the kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import floatops
from . import _build

_INF = 1e30
_IMAX = 2**31 - 1
MODES = {"best": 0, "first": 1}


def select_move(delta: torch.Tensor, valid: torch.Tensor, thr: float = 0.0,
                mode: str = "best") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ant move selection over an (m, M) delta tensor (the reference's
    ``ref.select_move``): ``best`` -> (least masked delta, its first
    index), 1e30 where every move is masked; ``first`` -> (delta, index)
    of the first move with delta < -thr, else (1e30, 2**31 - 1)."""
    ok = valid != 0
    if mode == "best":
        v = torch.where(ok, delta, floatops.const(_INF, delta))
        idx = torch.argmin(v, dim=-1)
        val = torch.gather(v, 1, idx[:, None])[:, 0]
        return val, idx.to(torch.int32)
    if mode == "first":
        imp = ok & (delta < floatops.const(-thr, delta))
        has = imp.any(dim=-1)
        # first True: argmax over 0/1 integers (no bool argmax on CUDA)
        idx = torch.argmax(imp.to(torch.uint8), dim=-1)
        val = torch.gather(delta, 1, idx[:, None])[:, 0]
        return (torch.where(has, val, floatops.const(_INF, delta)),
                torch.where(has, idx.to(torch.int32),
                            torch.full_like(idx, _IMAX, dtype=torch.int32)))
    raise ValueError(mode)


def two_opt_best_plain(add1: torch.Tensor, add2: torch.Tensor,
                       rem1: torch.Tensor, rem2: torch.Tensor,
                       valid: torch.Tensor, thr: float = 0.0,
                       mode: str = "best"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, M) operands -> ((m,) delta, (m,) int32 flat index)."""
    return select_move(add1 + add2 - rem1 - rem2, valid, thr, mode)


def two_opt_best(add1: torch.Tensor, add2: torch.Tensor, rem1: torch.Tensor,
                 rem2: torch.Tensor, valid: torch.Tensor, thr: float = 0.0,
                 mode: str = "best") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    if mode not in MODES:
        raise ValueError(mode)
    m, M = add1.shape
    dev = add1.device
    _build.require("two_opt_best add1", add1, torch.float32)
    for name, t in (("add2", add2), ("rem1", rem1), ("rem2", rem2)):
        _build.require("two_opt_best " + name, t, torch.float32, (m, M), dev)
    _build.require("two_opt_best valid", valid,
                   (torch.bool, torch.uint8, torch.int8), (m, M), dev)
    val = torch.empty(m, dtype=torch.float32, device=dev)
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("two_opt_best", dev, add1.data_ptr(), add2.data_ptr(),
                  rem1.data_ptr(), rem2.data_ptr(), valid.data_ptr(), m, M,
                  float(-np.float32(thr)), MODES[mode], val.data_ptr(),
                  idx.data_ptr())
    _build.count(two_opt_best)
    return val, idx


two_opt_best.launches = 0
