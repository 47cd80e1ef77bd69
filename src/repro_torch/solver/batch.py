"""Pad, bucket, stack: heterogeneous TSP instances as one batch.

The PyTorch port of ``repro.solver.batch``.  Instances are padded to the
next power-of-two city count >= ``min_bucket``, so a bucket serves every
instance size that lands in it and at most log2(n_max) buckets exist.

Masking invariants for a padded instance with ``n_actual`` real cities in
an ``n_pad`` bucket (the reference's):

- phantom cities (indices >= n_actual) sit at **inf distance** from
  everything, so eta = 1/d is **exactly 0** and no selection rule prefers
  them while a real city remains unvisited;
- every constructed tour is the real-city permutation at positions
  [0, n_actual) followed by the phantom tail n_actual..n_pad-1 in index
  order;
- tour lengths, deposits and local-search moves close the tour at
  position n_actual-1 -> 0 and mask phantom positions.

A batch stacks each instance's tensors on a leading B axis and carries
the instances' ``n_actual`` as a host tuple of ints beside them (the
port's ``Problem.n_actual`` is a host int): ``slot_problem`` gives one
instance's view, which is what the engine steps.  Bucket sizes are powers
of two from 16, so every slot's (n_pad, n_pad) view of a stacked float32
tensor starts on a 16-byte boundary, as the walk kernel needs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import tree
from ..core import aco, tsp
from ..sparse import store as sparse_store


def bucket_size(n: int, min_bucket: int = 16) -> int:
    """Next power-of-two >= max(n, min_bucket)."""
    if n < 1:
        raise ValueError(f"instance size {n} < 1")
    b = min_bucket
    while b < n:
        b <<= 1
    return b


def bucket_ladder(min_n: int, max_n: int, min_bucket: int = 16
                  ) -> list[int]:
    """Every bucket size instances in [min_n, max_n] can land in: the
    single source of the ladder."""
    if max_n < min_n:
        raise ValueError(f"max_n {max_n} < min_n {min_n}")
    lo = bucket_size(min_n, min_bucket)
    hi = bucket_size(max_n, min_bucket)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * 2)
    return out


def padded_problem(instance: tsp.TSPInstance, n_pad: int, nn_k: int = 30,
                   hyper: Optional[aco.Hyper] = None,
                   device: _device.DeviceLike = None) -> aco.Problem:
    """Mask-aware Problem for one instance padded to ``n_pad`` cities;
    ``n_actual`` is set even for an exact fit, so every slot of a batch
    runs the masked step.  ``hyper`` attaches per-instance operands."""
    dev = _device.resolve(device)
    padded = tsp.pad_instance(instance, n_pad)
    dist = torch.from_numpy(padded.distances()).to(dev)
    eta = tsp.heuristic_matrix(dist)     # 1/inf == 0 at phantom entries
    nn = tsp.nn_lists(dist, min(nn_k, n_pad - 1))
    return aco.Problem(dist, eta, nn, n_actual=instance.n, hyper=hyper)


def _stack_problems(problems: list):
    """Stack per-instance problems; ``n_actual`` becomes a host tuple."""
    first = problems[0]
    return type(first)(**{
        f: tuple(getattr(p, f) for p in problems) if f == "n_actual"
        else tree.stack([getattr(p, f) for p in problems])
        for f in first._fields})


def slot_problem(problem, b: int):
    """Slot ``b``'s view of a stacked ``Problem`` or ``SparseProblem``: its
    tensors' [b] (no copy) and its host int ``n_actual``."""
    return type(problem)(**{
        f: getattr(problem, f)[b] if f == "n_actual"
        else tree.index(getattr(problem, f), b)
        for f in problem._fields})


@dataclasses.dataclass(frozen=True)
class ProblemBatch:
    """B instances padded to one bucket, stacked for the engine."""
    problem: aco.Problem              # tensors (B, ...); n_actual (B,) ints
    instances: tuple[tsp.TSPInstance, ...]
    n_pad: int

    @property
    def size(self) -> int:
        return len(self.instances)


def make_batch(instances, n_pad: Optional[int] = None, nn_k: int = 30,
               min_bucket: int = 16,
               hypers: Optional[Sequence[Optional[aco.Hyper]]] = None,
               device: _device.DeviceLike = None) -> ProblemBatch:
    """Pad every instance to a common bucket and stack them.

    ``n_pad`` defaults to the bucket covering the largest instance.
    ``hypers``: per-instance Hyper profiles, all set or all None (a batch
    has one structure: mixing Hyper and non-Hyper slots would give its
    slots different steps).
    """
    instances = tuple(instances)
    if not instances:
        raise ValueError("empty batch")
    if n_pad is None:
        n_pad = bucket_size(max(i.n for i in instances), min_bucket)
    if hypers is None:
        hypers = [None] * len(instances)
    elif any(h is None for h in hypers) and any(h is not None for h in hypers):
        raise ValueError("hypers must be all-None or all-set within a batch")
    dev = _device.resolve(device)
    problems = [padded_problem(i, n_pad, nn_k, h, dev)
                for i, h in zip(instances, hypers)]
    return ProblemBatch(problem=_stack_problems(problems),
                        instances=instances, n_pad=n_pad)


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """B sparse instances padded to one (n_pad, k) page bucket.

    Duck-typed against ProblemBatch where it matters (``instances`` /
    ``n_pad``), so ``engine.collect`` serves both.  ``meta`` holds what
    the bucket's slots share: one rounding rule, one page width.
    """
    problem: sparse_store.SparseProblem   # tensors (B, ...); n_actual ints
    instances: tuple[tsp.TSPInstance, ...]
    meta: sparse_store.SparseBatchMeta

    @property
    def n_pad(self) -> int:
        return self.meta.n_pad

    @property
    def k(self) -> int:
        return self.meta.k

    @property
    def ewt(self) -> str:
        return self.meta.ewt

    @property
    def size(self) -> int:
        return len(self.instances)


def make_sparse_batch(instances, k: int, n_pad: Optional[int] = None,
                      min_bucket: int = 16,
                      device: _device.DeviceLike = None) -> SparseBatch:
    """Stack sparse problems into one (n_pad, k) bucket.  Every slot
    carries ``n_actual`` (exact fits too), so every slot runs the masked
    step."""
    instances = tuple(instances)
    if not instances:
        raise ValueError("empty batch")
    ewts = {i.edge_weight_type for i in instances}
    if len(ewts) > 1:
        raise ValueError(
            f"sparse bucket mixes edge weight types {sorted(ewts)}: the "
            "rounding rule is static per compiled sparse program")
    if n_pad is None:
        n_pad = bucket_size(max(i.n for i in instances), min_bucket)
    dev = _device.resolve(device)
    problems = [
        sparse_store.make_sparse_problem(i, k, n_pad, device=dev)._replace(
            n_actual=i.n)
        for i in instances]
    return SparseBatch(problem=_stack_problems(problems),
                       instances=instances,
                       meta=sparse_store.SparseBatchMeta(ewts.pop(), k,
                                                         n_pad))


Batch = Union[ProblemBatch, SparseBatch]


def group_by_bucket(sizes, min_bucket: int = 16) -> dict[int, list[int]]:
    """Index lists of ``sizes`` grouped by their bucket."""
    out: dict[int, list[int]] = {}
    for i, n in enumerate(sizes):
        out.setdefault(bucket_size(n, min_bucket), []).append(i)
    return out


def trim_tour(tour, n_actual: int) -> np.ndarray:
    """Drop the phantom tail of a padded tour -> real-city permutation."""
    if isinstance(tour, torch.Tensor):
        tour = tour.cpu().numpy()
    return np.asarray(tour)[:n_actual]
