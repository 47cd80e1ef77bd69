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
window sums the same way.  ``xla_sum`` reproduces that order.  A
``jnp.cumsum`` becomes a windowed scan there: blocks of 16 summed in
sequence, the blocks' totals scanned the same way and added to each
block (``xla_cumsum``; PyTorch's CPU ``cumsum`` accumulates float32 in
double precision, its CUDA one in a parallel order).

A ``jnp.einsum`` that contracts K terms into each output (a matrix-vector
product) is emitted inside a loop fusion and vectorised by LLVM, in an
order set by K and by the fusion: in sequence up to 42 terms, and past
that a main block whose 8 lanes each sum one residue mod 8 (its parts of
8 taken in a fixed permuted order) and are reduced by halves, then a
4-lane epilogue that starts from that total (as many rounds of 4 as fit,
or at most two where the fusion transposes the operand first), then the
tail in sequence.  ``xla_dot_sum`` reproduces the order measured for
K < 80 (jax 0.9.0 on an AVX-512 host, by rooted triples: one term 2^24,
two terms 1, the rest 0) and sums in index order beyond it.

A traced ``x ** p`` compiles to the C library's ``powf`` on the CPU,
which is neither PyTorch's vectorised power nor the correctly rounded
one; ``powf`` calls the same function there.

``jax.lax.erf_inv`` at float32 is XLA's own polynomial (M. Giles'
single-precision approximation), not PyTorch's ``erfinv``; ``erfinv``
evaluates the same polynomial, its Horner steps as fused multiply-adds.
Its ``log1p`` is PyTorch's, which differs from XLA's CPU one by an ulp
or two on some inputs, so the result is ulp-close, not bitwise.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional

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


# main block length -> the order its parts of 8 enter each lane's sum
_DOT_MAIN = ((64, (0, 4, 5, 1, 6, 2, 7, 3)), (48, (0, 2, 4, 3, 1, 5)),
             (32, (0, 1, 2, 3)))
_DOT_SEQUENTIAL, _DOT_MEASURED = 42, 80


def _halves(x: torch.Tensor) -> torch.Tensor:
    """Reduce the last axis (a power of two) by halves: lane i + lane
    i + h, h = n/2, n/4, ..., 1."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def xla_dot_sum(x: torch.Tensor, max_epilogue: Optional[int] = None
                ) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU matrix-vector
    product over that many terms (the module's docstring);
    ``max_epilogue``: the most rounds of the 4-lane epilogue (2 where the
    fusion transposes the operand, None for all that fit)."""
    k = x.shape[-1]
    if k <= _DOT_SEQUENTIAL or k >= _DOT_MEASURED:
        return _seq_sum(x)
    main, order = next(mo for mo in _DOT_MAIN if mo[0] <= k)
    parts = x[..., :main].reshape(*x.shape[:-1], main // 8, 8)
    acc = parts[..., order[0], :]
    for p in order[1:]:
        acc = acc + parts[..., p, :]
    total = _halves(acc)
    rounds = (k - main) // 4         # below 80 terms, fewer than 16 remain
    if max_epilogue is not None:
        rounds = min(rounds, max_epilogue)
    n_ep = 4 * rounds
    if n_ep:
        ep = x[..., main:main + n_ep].reshape(*x.shape[:-1], rounds, 4)
        # lane 0 starts from the main block's total
        acc = torch.cat([(total + ep[..., 0, 0])[..., None],
                         ep[..., 0, 1:]], -1)
        for i in range(1, rounds):
            acc = acc + ep[..., i, :]
        total = _halves(acc)
    for i in range(main + n_ep, k):
        total = total + x[..., i]
    return total


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan over the last axis, one add after another."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def xla_cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive sum over the last axis in the order of XLA's CPU
    ``cumsum`` (its reduce-window rewrite): the row zero-padded to blocks
    of ``block``, each block scanned in sequence, the blocks' totals
    scanned the same way (recursively), and the total of the blocks
    before each block added to it."""
    n = x.shape[-1]
    if n <= block:
        return _seq_cumsum(x)
    nb = -(-n // block)
    x = torch.nn.functional.pad(x, (0, nb * block - n))
    within = _seq_cumsum(x.reshape(*x.shape[:-1], nb, block))
    inc = xla_cumsum(within[..., -1], block)
    before = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    out = within + before[..., None]
    return out.reshape(*x.shape[:-1], nb * block)[..., :n]


@functools.lru_cache(maxsize=None)
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.frompyfunc(fn, 2, 1)


def powf(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``x ** p`` for float32 tensors that broadcast together (a 0-dim
    ``x`` or ``p`` included), as the reference's traced power computes
    it: on the CPU the C library's ``powf`` element by element (slow,
    exact to the reference), on CUDA the card's ``pow``."""
    if x.device.type != "cpu":
        return torch.pow(x, p)
    shape = torch.broadcast_shapes(x.shape, p.shape)
    out = _libm_powf()(x.numpy(), p.numpy())
    return torch.from_numpy(np.asarray(out, dtype=np.float32).reshape(
        tuple(shape)))


# XLA's ErfInv32: Horner coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jax.lax.erf_inv``: w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-1 give
    +-max float."""
    w = -torch.log1p(-x * x)
    small = w < const(5.0, x)
    w = torch.where(small, w - const(2.5, x), sqrt(w) - const(3.0, x))

    def coef(i):
        return torch.where(small, const(_ERFINV_LT5[i], x),
                           const(_ERFINV_GE5[i], x))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.addcmul(coef(i), p, w)
    return torch.where(torch.abs(x) == 1,
                       x * const(float(np.finfo(np.float32).max), x), p * x)
