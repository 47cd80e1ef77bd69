"""Probabilistic next-city selection rules and the threefry random stream.

The selection semantics are the reference's (``repro.core.sampling``):

- ``roulette``   exact inverse-CDF sampling (cumsum + count below the draw);
- ``iroulette``  the paper's independent roulette, argmax(w * U);
- ``gumbel``     exact categorical sampling via Gumbel-max;
- ``greedy``     deterministic argmax.

The random stream is the reference's, bit for bit: the threefry-2x32 hash
of ``jax.random`` with ``jax_threefry_partitionable`` on.  A key is the
reference's two uint32 words, held in an int64 tensor of shape (2,).  Bits
are computed in int64 arithmetic masked to 32 bits (PyTorch's ``uint32``
lacks most arithmetic):

- ``prng_key(s)`` is ``[s >> 32, s & 0xFFFFFFFF]``;
- ``split(key, k)[i]`` and ``fold_in(key, i)`` are ``threefry(key, (0, i))``;
- ``random_bits(key, shape)`` is ``y0 ^ y1`` of ``threefry(key, (hi, lo))``
  over the row-major flat index;
- ``counter_bits`` is ``y0`` of ``threefry(key, (i * 65536 + j, 0))``.

``uniform`` rounds its ``flo * span + minval`` once, as XLA's fused
multiply-add does.  ``gumbel`` uses ``torch.log``, which differs from
XLA's CPU ``log`` by an ulp on some inputs: gumbel draws are ulp-close to
the reference, not bitwise.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from . import floatops

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_NEG_INF = -1e30
_TINY = float(np.finfo(np.float32).tiny)

# (ant, city) -> counter stride of counter-mode draws (the reference's
# COUNTER_STRIDE): collision-free for widths up to 65536.
COUNTER_STRIDE = 1 << 16

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: IntLike, k1: IntLike, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32.

    ``k0``/``k1`` broadcast against the counters ``x0``/``x1``.
    """
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device: Union[str, torch.device] = "cpu"
             ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash_counters(key: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``threefry(key, (0, lo))`` -> (..., 2) derived keys."""
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash_counters(key, lo)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` may be a 1-D tensor of
    integers, giving one folded key per entry, (len(data), 2)."""
    if isinstance(data, torch.Tensor):
        lo = data.to(device=key.device, dtype=torch.int64) & _MASK
        return _hash_counters(key, lo)
    lo = torch.tensor([int(data) & _MASK], dtype=torch.int64,
                      device=key.device)
    return _hash_counters(key, lo)[0]


def fold_in_rows(keys: torch.Tensor, data: IntLike) -> torch.Tensor:
    """A (B, 2) key stack, row b ``fold_in(keys[b], data[b])`` (``data``
    a (B,) integer tensor or one host int for every row)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full(keys.shape[:1], int(data) & _MASK,
                          dtype=torch.int64, device=keys.device)
    lo = data.to(device=keys.device, dtype=torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64).  A (B, 2)
    stack of keys gives (B, *shape), row b bitwise ``random_bits(key[b],
    shape)``."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape)) if shape else 1
    flat = torch.arange(size, dtype=torch.int64, device=key.device)
    hi = flat >> 32
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, flat & _MASK)
    return (y0 ^ y1).reshape(tuple(key.shape[:-1]) + shape)


def counter_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Width-invariant bits for a 2-D (m, n) draw (reference counter mode).
    A (B, 2) stack of keys gives (B, m, n), row b bitwise
    ``counter_bits(key[b], shape)``."""
    m, n = shape
    if n > COUNTER_STRIDE:
        raise ValueError(f"counter draw width {n} > {COUNTER_STRIDE}")
    dev = key.device
    rows = torch.arange(m, dtype=torch.int64, device=dev) * COUNTER_STRIDE
    ctr = (rows[:, None] + torch.arange(n, dtype=torch.int64,
                                        device=dev)[None, :]) & _MASK
    lead = tuple(key.shape[:-1]) + (1, 1)
    y0, _ = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                         ctr, torch.zeros_like(ctr))
    return y0.reshape(tuple(key.shape[:-1]) + (m, n))


def _uniform_from_bits(bits: torch.Tensor, minval: float,
                       span: float) -> torch.Tensor:
    """bits -> U[minval, minval + span) float32, the ``jax.random.uniform``
    construction: 9-bit shift into [1, 2), subtract 1, one fused
    multiply-add into range, clamp low."""
    flo = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    flo = flo - 1.0
    lo = floatops.const(minval, flo)
    return torch.maximum(lo, torch.addcmul(lo, flo,
                                            floatops.const(span, flo)))


def uniform_span(draw_mode: str, minval: float, maxval: float) -> float:
    """The span a draw scales its [0, 1) floats by: ``uniform``'s is
    ``float32(maxval) - float32(minval)``; the reference's counter mode
    rounds ``maxval - minval`` from double precision."""
    if draw_mode == "counter":
        return maxval - minval
    return float(np.float32(maxval) - np.float32(minval))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``; its
    span is ``float32(maxval) - float32(minval)``."""
    return _uniform_from_bits(random_bits(key, shape), minval,
                              uniform_span("packed", minval, maxval))


def counter_uniform(key: torch.Tensor, shape: Sequence[int],
                    minval: float = 0.0, maxval: float = 1.0
                    ) -> torch.Tensor:
    """Width-invariant U[minval, maxval) for 2-D (m, n) shapes.  The
    reference's counter mode rounds its span from double precision, and
    inside its jitted programs XLA fuses the multiply-add."""
    return _uniform_from_bits(counter_bits(key, shape), minval,
                              uniform_span("counter", minval, maxval))


def gumbel_noise(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (ulp-close: ``torch.log``)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def counter_gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Width-invariant standard Gumbel draw."""
    return -torch.log(-torch.log(counter_uniform(key, shape, _TINY, 1.0)))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: IntLike) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``.

    The reference's algorithm: two 32-bit draws from ``split(key)``,
    combined as ``(hi % span) * (2^32 % span) + lo % span`` mod ``span``
    in wrapping uint32 arithmetic.  ``minval`` is a host int, ``maxval`` a
    host int or, with a (B, 2) stack of keys, a (B,) integer tensor of
    per-row bounds: row b is bitwise ``randint(key[b], shape, minval,
    maxval[b])``.
    """
    ks = split(key)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    if isinstance(maxval, torch.Tensor):
        # per row, in int64 tensors: every intermediate stays below 2^62
        span = maxval.to(device=key.device, dtype=torch.int64) - int(minval)
        span = torch.clamp_min(span, 1).reshape(
            (-1,) + (1,) * len(tuple(shape)))
    else:
        span = max(int(maxval) - int(minval), 1)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + (lower % span)
    off = (off & _MASK) % span
    return (int(minval) + off).to(torch.int32)


def roulette(key: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Exact inverse-CDF sampling; weights (..., n) >= 0, not normalised."""
    cdf = torch.cumsum(weights, dim=-1)
    total = cdf[..., -1:]
    u = uniform(key, weights.shape[:-1] + (1,))
    r = u * total
    idx = (cdf < r).sum(dim=-1)
    return idx.clamp(0, weights.shape[-1] - 1).to(torch.int32)


def iroulette(key: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The paper's independent roulette: argmax(w * U(1e-6, 1))."""
    u = uniform(key, weights.shape, minval=1e-6, maxval=1.0)
    return torch.argmax(weights * u, dim=-1).to(torch.int32)


def _log_weights(weights: torch.Tensor) -> torch.Tensor:
    return torch.where(weights > 0,
                       torch.log(torch.clamp_min(weights, 1e-38)),
                       floatops.const(_NEG_INF, weights))


def gumbel(key: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Exact categorical via Gumbel-max on log-weights; zeros -> -1e30."""
    g = gumbel_noise(key, weights.shape)
    return torch.argmax(_log_weights(weights) + g, dim=-1).to(torch.int32)


def greedy(key: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Deterministic argmax (ACS exploitation step)."""
    del key
    return torch.argmax(weights, dim=-1).to(torch.int32)


def iroulette_counter(key: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """``iroulette`` with counter-mode (width-invariant) uniforms."""
    u = counter_uniform(key, weights.shape, minval=1e-6, maxval=1.0)
    return torch.argmax(weights * u, dim=-1).to(torch.int32)


def gumbel_counter(key: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """``gumbel`` with counter-mode (width-invariant) Gumbel noise."""
    g = counter_gumbel(key, weights.shape)
    return torch.argmax(_log_weights(weights) + g, dim=-1).to(torch.int32)


SELECTORS = {
    "roulette": roulette,
    "iroulette": iroulette,
    "gumbel": gumbel,
    "greedy": greedy,
}

SELECTORS_COUNTER = {
    "roulette": roulette,
    "iroulette": iroulette_counter,
    "gumbel": gumbel_counter,
    "greedy": greedy,
}

DRAW_MODES = ("packed", "counter")


def get_selector(name: str, draw_mode: str = "packed"):
    """Selector fn for (selection, draw_mode); KeyError on unknown name."""
    if draw_mode not in DRAW_MODES:
        raise ValueError(f"unknown draw_mode {draw_mode!r}; "
                         f"supported: {', '.join(DRAW_MODES)}")
    table = SELECTORS_COUNTER if draw_mode == "counter" else SELECTORS
    return table[name]
