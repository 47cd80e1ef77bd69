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


def check_full_fp32(dev: torch.device, what: str) -> None:
    """A float32 matmul on the card must not round its inputs to TF32:
    raise if TF32 is enabled rather than change the precision (the
    default is full float32)."""
    if dev.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32 or
                               torch.get_float32_matmul_precision()
                               != "highest"):
        raise RuntimeError(
            f"{what} needs full float32 matmuls: TF32 is enabled "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); disable it")
