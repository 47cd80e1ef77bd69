"""float32 arithmetic with the reference's rounding, on any device.

Two habits of the reference's compiler (XLA on the CPU) decide the last
bit of several results, and eager PyTorch has neither by itself:

- XLA contracts ``a * b + c`` into one fused multiply-add (``fma``), a
  single rounding.  ``jax.random.uniform`` (``flo * span + minval``),
  ``pheromone.update`` (``(1 - rho) * tau + deposit``) and the ACS local
  rule do it; the port writes each as ``torch.addcmul(c, a, b)``, which
  rounds once on the CPU and on CUDA.
- A Python scalar in a JAX expression is rounded to float32 first and the
  operation is then exact IEEE float32.  PyTorch's CUDA division by a CPU
  scalar multiplies by its reciprocal instead, and ``scalar / tensor`` is
  ``reciprocal() * scalar`` on every device; ``const`` turns the scalar
  into a float32 tensor on the operand's device, which takes the plain
  division path.

And one habit of PyTorch's own: its vectorised CPU ``sqrt`` for float32
is not correctly rounded (about one result in 180 is an ulp off), where
XLA's and the card's are.  ``sqrt`` takes the root in float64 and rounds
once to float32, which is the correctly rounded float32 root.

A plain ``x.sum(-1)`` in the reference's jitted programs is rewritten by
XLA's CPU tree-reduction pass: over more than 32 elements it sums windows
of 32 in order (zero-padded, the padding split about the row), then the
window sums the same way.  ``xla_sum`` reproduces that order.
"""
from __future__ import annotations

import numpy as np
import torch


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor holding ``float32(value)`` on ``like``'s device
    (a fill on the device: no host-to-device copy, no stream sync)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device."""
    return torch.sqrt(x.double()).float()


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU reduction: windows
    of ``window`` elements summed in sequence from 0, the row zero-padded
    to a multiple of the window (``pad // 2`` in front), repeated until
    one window is left."""
    while x.shape[-1] > window:
        pad = (-x.shape[-1]) % window
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _seq_sum(x.reshape(*x.shape[:-1], -1, window))
    return _seq_sum(x)
