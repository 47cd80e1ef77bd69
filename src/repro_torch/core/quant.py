"""Quantised resident pheromone store, the PyTorch port of ``repro.core.quant``.

The colony keeps tau as a ``QuantTau`` payload between iterations and
computes on a transient float32 tensor: every step dequantises, updates
and requantises on store.  The representation per ``ACOConfig.tau_dtype``:

- ``fp32``  no wrapper: ``ColonyState.tau`` stays the raw float32 tensor;
- ``bf16``  ``q`` is tau rounded to bfloat16; ``scale``/``err`` are
  zero-width ``(rows, 0)`` tensors;
- ``int8``  ``q`` is int8 with a per-row float32 ``scale``
  (``max|row| / 127``, ``optim.compression.quantize_int8(axis=-1)``).

``tau_round="stochastic"`` rounds with uniform noise below the rounding
point (unbiased); ``"nearest"`` rounds half to even.  With compensation,
``err`` carries the float32 residual ``work - dequantised`` and is added
back before the next store.

Numbers: ``quantise`` gives the reference's eager numbers (its
``init_colony`` path); ``requantise`` runs only inside the reference's
jitted colony step, where XLA multiplies by float32(1/127) instead of
dividing and rounds the compensation's ``work - q * scale`` once (a fused
multiply-add), so ``requantise`` computes those numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..optim.compression import quantize_int8
from . import sampling

TAU_DTYPES = ("fp32", "bf16", "int8")
TAU_ROUNDS = ("stochastic", "nearest")

_MASK = 0xFFFFFFFF


class QuantTau(NamedTuple):
    """Quantised pheromone; every field always exists, unused ones are
    zero-width ``(rows, 0)`` float32 tensors (0 resident bytes)."""
    q: torch.Tensor      # int8 or bfloat16 payload, tau's shape
    scale: torch.Tensor  # (rows, 1) float32 per-row scale (int8), or (rows, 0)
    err: torch.Tensor    # float32 residual (compensation), or (rows, 0)


TauLike = Union[torch.Tensor, QuantTau]


def validate_tau_dtype(tau_dtype: str, tau_round: str = "stochastic") -> None:
    if tau_dtype not in TAU_DTYPES:
        raise ValueError(
            f"unknown tau_dtype {tau_dtype!r}; supported: "
            + " | ".join(TAU_DTYPES))
    if tau_round not in TAU_ROUNDS:
        raise ValueError(
            f"unknown tau_round {tau_round!r}; supported: "
            + " | ".join(TAU_ROUNDS))


def is_quantised(tau_dtype: str) -> bool:
    validate_tau_dtype(tau_dtype)
    return tau_dtype != "fp32"


def _zero_width(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-1] + (0,), dtype=torch.float32,
                       device=x.device)


def _round_bf16(x: torch.Tensor, key: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """float32 -> bfloat16; stochastic when a key is given: add 16 random
    bits below bfloat16's last place, then truncate (a carry into the
    exponent is the right round-up)."""
    if key is None:
        return x.to(torch.bfloat16)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK
    # a (B, 2) stack of keys draws each instance's bits over its own plane
    r = sampling.random_bits(key, tuple(x.shape[key.dim() - 1:])) & 0xFFFF
    bits = (bits + r) & 0xFFFF0000
    # uint32 -> int32 bit pattern, wrapped explicitly
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def _quantise(x: torch.Tensor, tau_dtype: str, compensation: bool,
              key: Optional[torch.Tensor], err: Optional[torch.Tensor],
              compiled: bool) -> QuantTau:
    validate_tau_dtype(tau_dtype)
    if tau_dtype == "fp32":
        raise ValueError("fp32 tau is stored raw, not wrapped")
    if x.shape[-1] == 0:
        # zero-width store: nothing to round, same fields and dtypes
        q = x.to(torch.bfloat16 if tau_dtype == "bf16" else torch.int8)
        scale = (torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                            device=x.device)
                 if tau_dtype == "int8" else _zero_width(x))
        return QuantTau(q=q, scale=scale, err=_zero_width(x))
    work = x if err is None or err.shape[-1] == 0 else x + err
    if tau_dtype == "bf16":
        q = _round_bf16(work, key)
        scale = _zero_width(x)
        if compensation:
            new_err = work - q.to(torch.float32)
    else:
        q, scale = quantize_int8(work, key=key, axis=-1, compiled=compiled)
        if compensation:
            q32 = q.to(torch.float32)
            # compiled: one rounding, as XLA's fused multiply-subtract.
            # The multiplicand is negated (exactly) rather than passing
            # value=-1, whose CUDA addcmul gives other last bits than the
            # CPU's in about a quarter of the cells.
            new_err = (torch.addcmul(work, q32.neg(), scale) if compiled
                       else work - q32 * scale)
    if not compensation:
        new_err = _zero_width(x)
    return QuantTau(q=q, scale=scale, err=new_err)


def quantise(x: torch.Tensor, tau_dtype: str, *, compensation: bool = False,
             key: Optional[torch.Tensor] = None,
             err: Optional[torch.Tensor] = None) -> QuantTau:
    """float32 tau -> QuantTau.  ``err`` carries the previous residual;
    ``key`` switches to stochastic rounding."""
    return _quantise(x, tau_dtype, compensation, key, err, compiled=False)


def requantise(x: torch.Tensor, prev: QuantTau, tau_dtype: str,
               key: Optional[torch.Tensor] = None) -> QuantTau:
    """Quantise-on-store after a float32 update step, carrying the previous
    residual (its width, 0 or full, says whether compensation is on).  A
    (B, n, n) stack takes a (B, 2) stack of round keys; each instance is
    bitwise its own call (row scales, its own draws)."""
    comp = prev.err.shape[-1] > 0
    return _quantise(x, tau_dtype, comp, key, prev.err, compiled=True)


def dequantise(tau: TauLike) -> torch.Tensor:
    """Any tau representation -> float32 (identity for raw fp32)."""
    if not isinstance(tau, QuantTau):
        return tau
    if tau.q.dtype == torch.int8:
        return tau.q.to(torch.float32) * tau.scale
    return tau.q.to(torch.float32)


def dequantise_rows(rows: torch.Tensor,
                    scale_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """Dequantise already-gathered payload rows."""
    if rows.dtype == torch.int8:
        return rows.to(torch.float32) * scale_rows
    if rows.dtype == torch.bfloat16:
        return rows.to(torch.float32)
    return rows


def tau_nbytes(tau: TauLike) -> int:
    """Resident bytes of one tau representation (payload + scales + err)."""
    parts = tau if isinstance(tau, QuantTau) else (tau,)
    return sum(t.numel() * t.element_size() for t in parts)


def round_key(tau_round: str, key: torch.Tensor) -> Optional[torch.Tensor]:
    """The key quantise-on-store consumes, or None for nearest rounding
    (the caller splits it off either way)."""
    return key if tau_round == "stochastic" else None
