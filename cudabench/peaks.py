"""The card's peaks and the operation and byte counts of the kernels.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 3.35 TB/s and
float32 67 TFLOP/s outside the tensor cores (NVIDIA's data sheet).  The
INT32 rate is not on the data sheet: 64 INT32 lanes per SM x 132 SMs x
the 1980 MHz boost clock = 16.73e12/s, derived from the H100 SXM
architecture and held fixed here, so the yardstick does not move with the
card a run lands on.

The counts are of what the inputs need, from the algorithm, not of what a
kernel happens to do; they are frozen here so that a change to a kernel
cannot change its own yardstick.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1980e6
# one threefry-2x32 hash: 60 integer operations in its 20 rounds (add,
# rotate, xor), 12 in the key injections and the counter set-up, 8 in the
# counter and the bits-to-float conversion
HASH_OPS = 80
# float32 operations per (step, ant, city): the weight tau * eta^2 (two
# products), the draw's scaling, the weighted draw and the comparison
WALK_FLOPS = 5


def walk_counts(n: int, m: int) -> tuple[float, float, float]:
    """(bytes, float32 operations, integer operations) of one dense walk
    of m ants over n cities with float32 tau: tau and eta read once, the
    starts, the keys and the (n - 1, m) picked cities written once; a hash
    per (step, ant, selectable city) -- the n - t unvisited cities at step
    t -- plus each ant's step keys in blocks of 128 steps."""
    nbytes = n * n * (4 + 4) + m * 4 + 16 + m * (n - 1) * 4
    flops = m * (n - 1) * n * WALK_FLOPS
    hashes = m * n * (n - 1) // 2 + m * -(-(n - 1) // 128) * 128
    return float(nbytes), float(flops), float(hashes * HASH_OPS)


def bound_s(nbytes: float, flops: float, int_ops: float) -> float:
    """Least time on the card: bytes over the HBM rate, or the float32 and
    integer operations over their rates, whichever is longest (the two
    pipes issue side by side)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S,
               int_ops / INT32_OPS_PER_S)
