"""Device resolution for the port's entry points.

Entry points run on the GPU by default.  A caller that wants the CPU asks
for it (``device="cpu"``), as the tests do; without a GPU and without that
request an entry point raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (RuntimeError without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
