"""int8 quantisation with symmetric scales, the PyTorch port of
``repro.optim.compression.quantize_int8``.

Only the quantiser is ported: the quantised pheromone store
(``core/quant.py``) needs it.  The gradient compression around it
(``compress_grads``, error-feedback state) waits for the multi-device
slice (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import floatops, sampling

# float32(1/127): the constant XLA multiplies by when it compiles the
# reference's division by 127.0 inside a jitted program.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


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
