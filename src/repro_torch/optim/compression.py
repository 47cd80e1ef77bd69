"""Gradient compression for a data-parallel all-reduce, the PyTorch port of
``repro.optim.compression``.

int8 quantisation with symmetric per-tensor scales (``quantize_int8``,
which the quantised pheromone store shares, ``core/quant.py``) and error
feedback: the quantisation residual is carried in a
``CompressionState`` and added to the next step's gradient, so the
rounding error does not accumulate.  ``key`` switches round-half-even to
stochastic rounding, leaf i drawing from ``fold_in(key, i)``.  With 8-bit
payloads the bytes an all-reduce moves drop 4x against float32.

Nothing on the card's solver path calls the gradient half yet; it is the
optimiser substrate the LM port (ROADMAP queue 1 item 18) builds on, held
against the reference on the CPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import tree
from ..core import floatops, sampling

PyTree = Any

# float32(1/127): the constant XLA multiplies by when it compiles the
# reference's division by 127.0 inside a jitted program.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


class CompressionState(NamedTuple):
    error: PyTree          # error-feedback residuals (float32)


def compression_init(params: PyTree) -> CompressionState:
    return CompressionState(error=tree.map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        params))


def quantize_int8(x: torch.Tensor, key: Optional[torch.Tensor] = None,
                  axis: Optional[int] = None, *, compiled: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 quantisation with symmetric scales -> (q int8, scale f32).

    ``axis=None`` gives one scalar scale for the tensor; an integer axis
    gives one scale per slice along it, kept as a size-1 dim so that
    ``q * scale`` broadcasts back.  ``key`` switches round-half-even to
    stochastic rounding, ``floor(y + U[0, 1))`` with the reference's
    ``jax.random.uniform`` draw.

    ``scale = max(amax, 1e-12) / 127`` as the reference's eager call
    computes it.  Inside a jitted program (the reference's colony step)
    XLA multiplies by float32(1/127) instead; ``compiled=True`` gives
    those numbers.
    """
    if axis is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    amax = torch.maximum(amax, floatops.const(1e-12, x))
    if compiled:
        scale = amax * floatops.const(_INV_127, x)
    else:
        scale = amax / floatops.const(127.0, x)
    y = x / scale
    if key is not None:                       # stochastic rounding
        # a (B, 2) stack of keys draws each instance's own plane
        y = torch.floor(y + sampling.uniform(key,
                                             tuple(y.shape[key.dim() - 1:])))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_grads(grads: PyTree, state: Optional[CompressionState],
                   key: Optional[torch.Tensor] = None
                   ) -> tuple[PyTree, PyTree, CompressionState]:
    """-> (int8 tree, scales tree, new error state).  Leaves are taken in
    the reference's order (field order, dict keys sorted)."""
    if state is None:
        state = compression_init(grads)
    leaves = tree.flatten(grads)
    errs = tree.flatten(state.error)
    qs, scales, new_errs = [], [], []
    for i, (g, e) in enumerate(zip(leaves, errs)):
        gf = g.to(torch.float32) + e
        k = None if key is None else sampling.fold_in(key, i)
        q, s = quantize_int8(gf, k)
        qs.append(q)
        scales.append(s)
        new_errs.append(gf - q.to(torch.float32) * s)
    return (tree.unflatten(grads, qs), tree.unflatten(grads, scales),
            CompressionState(tree.unflatten(grads, new_errs)))


def decompress_grads(q: PyTree, scales: PyTree,
                     dtype: torch.dtype = torch.float32) -> PyTree:
    return tree.map(lambda qq, ss: dequantize_int8(qq, ss, dtype), q, scales)
