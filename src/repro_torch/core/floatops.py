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
"""
from __future__ import annotations

import numpy as np
import torch


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor holding ``float32(value)`` on ``like``'s device
    (a fill on the device: no host-to-device copy, no stream sync)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=like.device)

