"""Per-iteration convergence metrics: the StepMetrics row of one step.

The PyTorch port of ``repro.obs.metrics``.  ``ACOConfig.metrics=True``
makes every colony step -- dense (``core.aco.colony_step``) and sparse
(``sparse.aco.sparse_colony_step``) -- return a ``StepMetrics`` beside the
new state.  The engine (``solver.engine.run_batch``) keeps one row per
instance next to the stacked state, frozen by the same done mask, and
``core.aco.run_scan`` stacks one row per iteration.

Exactness contract: metrics are read-only reductions over intermediates
the step already computes -- no extra draw, no reordering of the state's
computation -- so tours, lengths, tau and keys are bitwise the same with
metrics on or off.

Every field is a 0-dim tensor (float32 or int32); fields that do not apply
to a route hold 0 (``ls_accept`` without local search, ``ovf_*`` on the
dense route, ``clamp_*`` outside MMAS).  ``stagnation`` is stamped by the
drivers that carry the count of non-improving iterations (the engine's
``since``, ``run_scan``'s loop); a step emits 0.

Means (``mean_len``, ``tau_mean`` and the clamp fractions) divide the sum
by the element count as the reference's compiled program does, by
multiplying with the float32 reciprocal; the sum order of a jitted
reduction is XLA's, so these four fields are ulp-close to the
reference's, not bitwise (``tests/test_torch_obs.py`` states the
tolerance).

The batched step (``core.aco.colony_step_batch``) gives (B,)-stacked rows
from (B, ...) intermediates.  A sum's order may depend on its operand's
shape and alignment on the card, so each instance's mean is taken over its
own plane, 16-byte aligned as a solo step's tensor is: each row is bitwise
its solo step's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# field -> short meaning; the documented metrics schema the services
# export.
FIELDS = {
    "it_best_len": "iteration-best tour length",
    "mean_len": "mean constructed-tour length over ants",
    "best_len": "global best length after this iteration",
    "improved": "1 iff the global best improved this iteration",
    "stagnation": "consecutive non-improving iterations (driver-stamped)",
    "ls_accept": "fraction of tours local search strictly improved",
    "tau_min": "pheromone minimum",
    "tau_max": "pheromone maximum",
    "tau_mean": "pheromone mean",
    "clamp_lo": "fraction of tau entries at the MMAS lower clamp",
    "clamp_hi": "fraction of tau entries at the MMAS upper clamp",
    "ovf_adopted": "sparse overflow slots adopted this iteration",
    "ovf_evicted": "sparse overflow slots evicted this iteration",
}


class StepMetrics(NamedTuple):
    it_best_len: torch.Tensor   # () f32
    mean_len: torch.Tensor      # () f32
    best_len: torch.Tensor      # () f32
    improved: torch.Tensor      # () i32
    stagnation: torch.Tensor    # () i32
    ls_accept: torch.Tensor     # () f32
    tau_min: torch.Tensor       # () f32
    tau_max: torch.Tensor       # () f32
    tau_mean: torch.Tensor      # () f32
    clamp_lo: torch.Tensor      # () f32
    clamp_hi: torch.Tensor      # () f32
    ovf_adopted: torch.Tensor   # () i32
    ovf_evicted: torch.Tensor   # () i32


_I32 = ("improved", "stagnation", "ovf_adopted", "ovf_evicted")


def _dtype(field: str) -> torch.dtype:
    return torch.int32 if field in _I32 else torch.float32


def zeros(device) -> StepMetrics:
    """Scalar zero metrics (a fresh slot)."""
    return StepMetrics(**{f: torch.zeros((), dtype=_dtype(f), device=device)
                          for f in StepMetrics._fields})


def zeros_batch(b: int, device) -> StepMetrics:
    """(B,)-stacked zero metrics: the engine's initial rows."""
    return StepMetrics(**{f: torch.zeros((b,), dtype=_dtype(f),
                                         device=device)
                          for f in StepMetrics._fields})


def stack(rows: Sequence[StepMetrics]) -> StepMetrics:
    """Rows -> one StepMetrics with every field stacked on a new axis 0."""
    return StepMetrics(*(torch.stack(col) for col in zip(*rows)))


def _mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean as the reference's jitted ``jnp.mean``: the sum times
    the float32 reciprocal of the count."""
    recip = np.float32(1.0) / np.float32(x.numel())
    return x.sum(dtype=torch.float32) * torch.full(
        (), float(recip), dtype=torch.float32, device=x.device)


def _slot_means(x: torch.Tensor) -> torch.Tensor:
    """(B,) means of each instance's plane of a (B, ...) tensor, each as
    ``_mean`` of that plane alone (copied where it would not start on a
    16-byte boundary, as a fresh solo tensor does)."""
    def plane(v):
        return v if v.data_ptr() % 16 == 0 else v.clone()
    return torch.stack([_mean(plane(x[b])) for b in range(x.shape[0])])


def tau_stats(tau: torch.Tensor,
              clamp: Optional[tuple[torch.Tensor, torch.Tensor]] = None
              ) -> dict:
    """min/max/mean of a pheromone tensor plus the MMAS clamp-saturation
    fractions (entries exactly at a bound: after ``clamp`` a saturated
    entry equals the bound bitwise).  Dense (n, n) and sparse (n, k)
    alike; a padded instance's statistics cover the padded buffer.  A
    (B, n, n) stack with (B,) bounds gives (B,) statistics."""
    batched = tau.dim() == 3
    if batched:
        mean, dims = _slot_means, (-2, -1)
        lo, hi = (None, None) if clamp is None else \
            (c.reshape(-1, 1, 1) for c in clamp)
        out = {"tau_min": tau.amin(dim=dims), "tau_max": tau.amax(dim=dims)}
    else:
        mean = _mean
        lo, hi = (None, None) if clamp is None else clamp
        out = {"tau_min": tau.min(), "tau_max": tau.max()}
    out["tau_mean"] = mean(tau)
    if clamp is not None:
        out["clamp_lo"] = mean((tau == lo).to(torch.float32))
        out["clamp_hi"] = mean((tau == hi).to(torch.float32))
    else:
        zero = torch.zeros(tau.shape[:1] if batched else (),
                           dtype=torch.float32, device=tau.device)
        out["clamp_lo"] = out["clamp_hi"] = zero
    return out


def step_metrics(lengths: torch.Tensor, it_best_len: torch.Tensor,
                 best_len: torch.Tensor, improved: torch.Tensor,
                 tau: torch.Tensor,
                 clamp: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                 pre_ls_lengths: Optional[torch.Tensor] = None,
                 ovf_adopted: Optional[torch.Tensor] = None,
                 ovf_evicted: Optional[torch.Tensor] = None) -> StepMetrics:
    """One step's metrics from intermediates the step already holds.
    ``pre_ls_lengths``: constructed-tour lengths before local search (None
    without local search: ls_accept reports 0).  (B, m) ``lengths`` are a
    batched step's: every field comes out (B,), row b bitwise instance b's
    solo step."""
    dev = lengths.device
    batched = lengths.dim() == 2
    lead = lengths.shape[:1] if batched else ()
    mean = _slot_means if batched else _mean
    zero_f = torch.zeros(lead, dtype=torch.float32, device=dev)
    zero_i = torch.zeros(lead, dtype=torch.int32, device=dev)
    ls_accept = zero_f if pre_ls_lengths is None else mean(
        (lengths < pre_ls_lengths).to(torch.float32))
    return StepMetrics(
        it_best_len=it_best_len.to(torch.float32),
        mean_len=mean(lengths),
        best_len=best_len.to(torch.float32),
        improved=improved.to(torch.int32),
        stagnation=zero_i,
        ls_accept=ls_accept,
        ovf_adopted=zero_i if ovf_adopted is None
        else ovf_adopted.to(torch.int32),
        ovf_evicted=zero_i if ovf_evicted is None
        else ovf_evicted.to(torch.int32),
        **tau_stats(tau, clamp),
    )


def to_host(mets: StepMetrics, index: Optional[int] = None) -> dict:
    """One metrics row as a plain JSON-ready dict.  ``index`` selects an
    instance row of a (B,)-stacked StepMetrics; None reads scalar
    metrics."""
    out = {}
    for f, v in zip(StepMetrics._fields, mets):
        x = v if index is None else v[index]
        out[f] = int(x) if f in _I32 else float(x)
    return out
