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


def selection_inputs(m: int, n: int, seed: int):
    """Seeded (tau, eta, visited, rand, cur) for the selection kernels."""
    rng = np.random.default_rng(seed)
    tau = (rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32)
    eta = (1.0 / (rng.random((n, n)) * 100 + 1)).astype(np.float32)
    visited = rng.random((m, n)) < 0.5
    rand = (rng.random((m, n)) * (1 - 1e-6) + 1e-6).astype(np.float32)
    cur = rng.integers(0, n, m).astype(np.int32)
    return tau, eta, visited, rand, cur


def jax_scores(rows, visited, rand, n_actual, mode) -> np.ndarray:
    """The reference's gumbel transform in NumPy float32 (the scores the
    tie rule of ``assert_picks`` reads)."""
    n = rows.shape[1]
    mask = (~visited) & (np.arange(n) < (n if n_actual is None else n_actual))
    g = -np.log(-np.log(np.clip(rand, np.float32(1e-12),
                                np.float32(1 - 1e-7))))
    return np.where((rows > 0) & mask,
                    np.log(np.maximum(rows, np.float32(1e-38))) + g,
                    np.float32(-1e30)).astype(np.float32)


def assert_picks(want, got, mode: str, scores) -> None:
    """Selected cities bitwise; for gumbel (``torch.log`` is an ulp off
    XLA's) a pick may differ only where the two candidates' reference
    scores lie within 4 ulp."""
    want, got = np.asarray(want), to_np(got)
    if mode != "gumbel":
        assert_bitwise(want, got, mode)
        return
    rows = np.nonzero(want != got)[0]
    d = ulp_distance(scores[rows, want[rows]], scores[rows, got[rows]])
    assert d.max(initial=0) <= 4, d


def cuda_device() -> torch.device:
    """The CUDA device, or skip (decided inside the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


class OnCard:
    """A CPU tensor that reports a CUDA device: it reaches the launchers'
    dtype and shape checks, which run before anything touches a card."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


def per_slot_steps(problem, states, budgets, cfg, max_iters, patience=0):
    """The reference semantics of a batched engine: each slot of a stacked
    ``problem``/``states`` stepped alone by ``colony_step`` until its
    budget or patience stops it -> (states, since, metrics rows)."""
    from repro_torch import tree
    from repro_torch.core import aco
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.solver import batch
    out, since_out, rows = [], [], []
    for b in range(states.key.shape[0]):
        p, s = batch.slot_problem(problem, b), tree.index(states, b)
        since = torch.zeros((), dtype=torch.int32)
        row = tree.index(obs_metrics.zeros_batch(1, "cpu"), 0)
        for _ in range(max_iters):
            if int(s.iteration) >= budgets[b] or \
                    (patience and int(since) >= patience):
                break
            res = aco.colony_step(p, s, cfg)
            improved = res[0].best_len < s.best_len
            since = torch.where(improved, torch.zeros_like(since), since + 1)
            if cfg.metrics:
                row = res[2]._replace(stagnation=since)
            s = res[0]
        out.append(s)
        since_out.append(since)
        rows.append(row)
    return tree.stack(out), torch.stack(since_out), obs_metrics.stack(rows)


# mantissa bits: one ulp of a value in [2^e, 2^(e+1)) is 2^(e - bits)
F32_BITS, BF16_BITS = 23, 7


def _f32(x) -> np.ndarray:
    """A JAX array, torch tensor (bf16 too) or NumPy array as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def ulp_of_scale(x, bits: int) -> float:
    """One ulp, in a float format with ``bits`` mantissa bits, of the
    largest magnitude in ``x``."""
    scale = float(np.abs(_f32(x)).max())
    return 2.0 ** (np.floor(np.log2(scale)) - bits) if scale > 0 else 0.0


def assert_ulps_of_scale(want, got, bits: int, ulps: float,
                         what: str = "") -> float:
    """``max |want - got|`` within ``ulps`` ulps (``bits`` mantissa bits)
    of ``want``'s largest magnitude; returns the error in those ulps."""
    a, b = _f32(want), _f32(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    unit = ulp_of_scale(a, bits)
    if not unit:
        assert (a == b).all(), f"{what}: want all zero"
        return 0.0
    err = float(np.abs(a - b).max()) / unit
    assert err <= ulps, f"{what}: {err:.3g} ulps of the scale > {ulps}"
    return err
