"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Data crosses between the JAX package and the PyTorch port as NumPy arrays.
"""
import numpy as np
import pytest
import torch


def to_np(x) -> np.ndarray:
    """A JAX array, torch tensor or NumPy array as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bitwise(a, b, what: str = "") -> None:
    """Equal bit for bit (float compared through their integer bits)."""
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        a = a.astype(np.float32).view(np.int32)
        b = b.astype(np.float32).view(np.int32)
    else:
        a, b = a.astype(np.int64), b.astype(np.int64)
    bad = int((a != b).sum())
    assert bad == 0, f"{what}: {bad} of {a.size} elements differ"


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 ulps (monotone integer mapping)."""
    def key(x):
        i = to_np(x).astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def cuda_device() -> torch.device:
    """The CUDA device, or skip (decided inside the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")
