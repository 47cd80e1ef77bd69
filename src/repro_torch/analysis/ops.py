"""Op-level accounting for the roofline analysis, the port's counterpart
of ``repro.analysis.hlo``.

The reference parses XLA's post-SPMD HLO text: a ``while`` body is
written once there and runs ``trip_count`` times, so ``hlo.py`` recovers
each loop's trip count from its condition and multiplies.  The port has
no HLO.  It runs eagerly and unrolls its loops in Python (the layers,
the decode steps, the colony's construction steps), so every iteration
dispatches its own operations and there is no trip count to recover.
``accumulate`` therefore runs the function under a ``TorchDispatchMode``
(on ``meta``, which computes and allocates nothing, or on the card) and
counts what is dispatched:

- ``dot_flops``: 2 * prod(output dims) * prod(contracting dims) of every
  matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``addmv``, ``dot``: what ``matmul``, ``einsum`` and ``linear`` reach,
  forward and backward), ``hlo.py``'s rule.  Elementwise work is
  excluded; a hand-written kernel (``kernel``) counts its bytes and 0
  FLOPs.
- ``bytes_accessed``: operand plus result bytes of every dispatched op
  that is not a view: the unfused upper bound, the counterpart of the
  reference's CPU-HLO "bytes accessed".
- memory, the counterpart of ``memory_analysis()``: the argument and
  output bytes (``placed_bytes`` of the inputs and of the result) and
  ``temp_size_in_bytes``, the peak of live bytes above the arguments:
  every storage an op creates counts from its creation until a
  weak-reference finalizer sees it freed (views share their storage and
  count once).
- collectives, which ``core/collectives.py`` and ``models/sharded.py``
  report themselves (``collective``): output bytes by the reference's
  kind names, and their count.

Every figure is per mesh position.  Work is attributed to the positions
of the innermost ``at_position`` (position 0 outside any); an operation
over a stack of P positions' rows (the city-sharded colony steps the
positions that share a device as one stack) is split evenly over them.
Where one number is needed, the position with the largest figure is
reported.

Two reductions keep a trace at production scale within seconds; each is
exact where its premise holds, and the caller opts in:

- ``sample=k``: a loop written ``for t in trip(range(...))`` runs its
  first k iterations, and the counts those added are scaled to the whole
  trip (the premise: every iteration dispatches the same operations on
  the same shapes, as the colony's construction steps do; values are
  then wrong, so use it on ``meta`` only).
- ``data_spec=``: every data-parallel group does the same work, and
  within the first group the positions other than its first (which runs
  the group's layers) that hold the same shapes do the same work too;
  a step that asks ``runs(pos)`` runs one representative of each such
  class, and each other position is given its representative's counts
  (``representatives``).

The accumulator is a module-level variable, not a ``ContextVar``: on
the card autograd runs a backward on its own device thread, which a
context variable set in the caller's thread does not reach.  Outside
``accumulate`` every hook here is a no-op and no value changes.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# op -> index of the operand whose last dimension is contracted
_PRODUCTS = {
    _aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
    _aten.dot.default: 0, _aten.addmm.default: 1,
    _aten.baddbmm.default: 1, _aten.addmv.default: 1,
}
# ops that move no bytes: fresh allocations without a write
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}

_QUIET: dict = {}           # op -> moves no bytes (a view, an allocation)
_ACTIVE: Optional["Accumulator"] = None
_AT: tuple = (0,)
_WEIGHT: float = 1.0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _operands(args, kwargs) -> list:
    """The tensors among an op's operands (an aten op's are tensors or
    flat lists of them)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _dot_flops(func, args, out) -> float:
    """``hlo.py``'s dot rule for one dispatched op (0 if it is not a
    matrix product)."""
    k = _PRODUCTS.get(func)
    if k is None:
        return 0.0
    return 2.0 * out.numel() * args[k].shape[-1]


class Accumulator(TorchDispatchMode):
    """Per-position counts over ``size`` positions; ``rep[p]`` is the
    position whose counts p is given (itself unless ``data_spec`` made
    it a copy); ``sample`` the iterations ``trip`` runs of a loop."""

    def __init__(self, size: int = 1, rep: Optional[Sequence[int]] = None,
                 sample: Optional[int] = None, folded: int = 1):
        super().__init__()
        self.size = size
        self.rep = list(range(size)) if rep is None else list(rep)
        self.sample = sample
        self.folded = folded
        self.flops = [0.0] * size
        self.bytes = [0.0] * size
        self.coll = {k: [0.0] * size for k in COLLECTIVES}
        self.count = [0.0] * size
        self.live = [0.0] * size
        self.peak = [0.0] * size
        self._storages: dict = {}
        self._closed = False

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        at = _AT
        w = _WEIGHT / len(at)
        flops = _dot_flops(func, args, out)
        ins = _operands(args, kwargs)
        outs = ([out] if isinstance(out, torch.Tensor)
                else _operands(out if isinstance(out, (list, tuple))
                               else (out,), {}))
        known = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in known]
        quiet = _QUIET.get(func)
        if quiet is None:
            quiet = _QUIET[func] = func.is_view or func in _NO_TRAFFIC
        traffic = 0 if quiet else (
            sum(map(nbytes, ins)) + sum(map(nbytes, fresh)))
        for p in at:
            self.flops[p] += flops * w
            self.bytes[p] += traffic * w
        for t in fresh:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            b = st.nbytes() / len(at)
            self._storages[key] = (at, b)
            weakref.finalize(st, self._freed, key)
            for p in at:
                self.live[p] += b
                if self.live[p] > self.peak[p]:
                    self.peak[p] = self.live[p]
        return out

    def _freed(self, key: int) -> None:
        at, b = self._storages.pop(key)
        if not self._closed:
            for p in at:
                self.live[p] -= b

    # ------------------------------------------------------------- reports
    def collective(self, kind: str, sizes: Iterable[tuple[int, int]]) -> None:
        for p, b in sizes:
            self.coll[kind][p] += b
            self.count[p] += 1

    def kernel(self, reads: Sequence[torch.Tensor],
               writes: Sequence[torch.Tensor]) -> None:
        traffic = sum(map(nbytes, reads)) + sum(map(nbytes, writes))
        for p in _AT:
            self.bytes[p] += traffic * _WEIGHT / len(_AT)

    def _counters(self) -> list:
        return [self.flops, self.bytes, self.count] + list(self.coll.values())

    def scale_since(self, before: list, factor_num: int,
                    factor_den: int) -> None:
        """Scale what was added since ``before`` (a ``snapshot``) by
        num / den."""
        for now, was in zip(self._counters(), before):
            for p in range(self.size):
                now[p] = was[p] + (now[p] - was[p]) * factor_num / factor_den

    def snapshot(self) -> list:
        return [list(c) for c in self._counters()]


@contextlib.contextmanager
def at_position(*positions: int, weight: float = 1.0):
    """Attribute the work inside to ``positions`` (split evenly), its
    FLOPs and bytes counted ``weight`` times."""
    global _AT, _WEIGHT
    saved = _AT, _WEIGHT
    _AT, _WEIGHT = tuple(positions) or (0,), weight
    try:
        yield
    finally:
        _AT, _WEIGHT = saved


def folded() -> int:
    """The data-parallel groups one group's run stands for: the groups
    of ``accumulate(..., data_spec=...)``, else 1.  What the first group
    delivers to a position (a gradient slice) each group delivers, so
    the step counts it this many times."""
    return 1 if _ACTIVE is None else _ACTIVE.folded


def here() -> tuple:
    """The positions the work dispatched now is attributed to."""
    return _AT


def runs(pos: int) -> bool:
    """Whether a step runs position ``pos``'s own work: always, except
    inside ``accumulate(..., data_spec=...)`` for a position that takes
    its representative's counts."""
    return _ACTIVE is None or _ACTIVE.rep[pos] == pos


def trip(iterable: Iterable):
    """The loop's items; inside ``accumulate(..., sample=k)`` only the
    first k, the counts they added scaled to the whole trip."""
    acc = _ACTIVE
    if acc is None or acc.sample is None:
        yield from iterable
        return
    items = list(iterable)
    k = min(acc.sample, len(items))
    before = acc.snapshot()
    for item in items[:k]:
        yield item
    if k:
        acc.scale_since(before, len(items), k)


def collective(kind: str, sizes: Iterable[tuple[int, int]]) -> None:
    """Report a collective: (position, its output bytes) pairs."""
    if _ACTIVE is not None:
        if kind not in COLLECTIVES:
            raise ValueError(kind)
        _ACTIVE.collective(kind, sizes)


def kernel(reads: Sequence[torch.Tensor],
           writes: Sequence[torch.Tensor]) -> None:
    """Report a hand-written kernel's launch: the bytes it reads and
    writes, 0 FLOPs (the dispatch mode does not see a launch)."""
    if _ACTIVE is not None:
        _ACTIVE.kernel(reads, writes)


def placed_bytes(obj, size: int = 1) -> list[int]:
    """The bytes each of ``size`` positions holds of ``obj``: the
    shards of a ``ShardedModel`` or ``ShardedCache``, and any list of
    ``size`` tensors (the per-position shards of a value over a mesh, as
    the moments and the colony's slabs are; None where a position holds
    nothing), one per position; any other tensor (a module's parameters
    too) on position 0.  A storage counts once a position."""
    out = [0] * size
    seen: set = set()

    def add(pos: int, t: torch.Tensor) -> None:
        key = (pos, t.untyped_storage()._cdata)
        if key not in seen:
            seen.add(key)
            out[pos] += nbytes(t)

    def walk(node) -> None:
        if isinstance(node, torch.Tensor):
            add(0, node)
        elif hasattr(node, "shards") and hasattr(node, "mesh"):
            walk(node.shards)
        elif isinstance(node, torch.nn.Module):
            for t in list(node.parameters()) + list(node.buffers()):
                add(0, t)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            if (size > 1 and len(node) == size and not hasattr(node, "_fields")
                    and any(isinstance(t, torch.Tensor) for t in node)
                    and all(t is None or isinstance(t, torch.Tensor)
                            for t in node)):
                for p, t in enumerate(node):
                    if t is not None:
                        add(p, t)
            else:
                for v in node:
                    walk(v)

    walk(obj)
    return out


def _shapes_by_position(obj, size: int) -> list:
    """Each position's sorted shapes of what ``placed_bytes`` places
    there (its signature as a holder)."""
    out: list = [[] for _ in range(size)]

    def walk(node) -> None:
        if hasattr(node, "shards") and hasattr(node, "mesh"):
            walk(node.shards)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            if (len(node) == size and not hasattr(node, "_fields") and all(
                    t is None or isinstance(t, torch.Tensor) for t in node)):
                for p, t in enumerate(node):
                    if t is not None:
                        out[p].append((tuple(t.shape), t.dtype))
            else:
                for v in node:
                    walk(v)

    walk(obj)
    return [tuple(sorted(x, key=repr)) for x in out]


def representatives(mesh, data_spec: Sequence, held=None) -> list[int]:
    """Each position's representative.  First the position of the first
    data-parallel group (batch chunk 0 of ``data_spec``) with the same
    coordinates on the axes that do not split the batch; then, within
    that group, the first position that holds the same shapes of
    ``held`` (the step's arguments) and, like it, is or is not the
    group's first position (the one that runs the group's layers): such
    positions do the same work."""
    from ..models.sharding import axes_of
    batch = set(axes_of(data_spec[0]))
    shape = mesh.devices.shape
    out = []
    for pos in range(mesh.size):
        coords = list(np.unravel_index(pos, shape))
        for d, a in enumerate(mesh.axis_names):
            if a in batch:
                coords[d] = 0
        out.append(int(np.ravel_multi_index(coords, shape)))
    if held is not None:
        sig = _shapes_by_position(held, mesh.size)
        first: dict = {}
        for pos in sorted(set(out)):
            first.setdefault((pos == 0, sig[pos]), pos)
        out = [first[(r == 0, sig[r])] for r in out]
    return out


def _largest(values: Sequence[float]) -> int:
    return int(np.argmax(values)) if len(values) else 0


def accumulate(fn: Callable, *args, mesh=None, data_spec=None,
               sample: Optional[int] = None, **kw) -> dict:
    """Run ``fn(*args, **kw)`` under an accumulator over ``mesh``'s
    positions (one without a mesh) -> the reference's keys:
    ``dot_flops``, ``collective_bytes`` (by kind), ``collective_total``,
    ``collective_count`` (of the position with the largest total), plus
    ``bytes_accessed`` and ``memory`` (``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``temp_size_in_bytes``), each the largest
    position's, ``positions`` (every figure per position) and ``out``
    (what ``fn`` returned).  ``data_spec`` and ``sample`` are the
    reductions of the module docstring."""
    global _ACTIVE
    size = 1 if mesh is None else mesh.size
    rep, groups = None, 1
    if data_spec is not None:
        from ..models.sharding import axes_of
        rep = representatives(mesh, data_spec, (args, kw))
        groups = int(np.prod([mesh.shape[a] for a in axes_of(data_spec[0])]))
    args_bytes = placed_bytes((args, kw), size)
    acc = Accumulator(size, rep, sample, groups)
    if _ACTIVE is not None:
        raise RuntimeError("accumulate does not nest")
    _ACTIVE = acc
    try:
        with acc:
            out = fn(*args, **kw)
    finally:
        _ACTIVE = None
    out_bytes = placed_bytes(out, size)
    acc._closed = True
    per = {"dot_flops": acc.flops, "bytes_accessed": acc.bytes,
           "collective_count": acc.count,
           "temp_size_in_bytes": acc.peak}
    per.update({f"collective_bytes/{k}": v for k, v in acc.coll.items()})
    for key, vals in per.items():
        per[key] = [vals[r] for r in acc.rep]
    per["argument_size_in_bytes"] = args_bytes
    per["output_size_in_bytes"] = [out_bytes[r] for r in acc.rep]
    totals = [sum(per[f"collective_bytes/{k}"][p] for k in COLLECTIVES)
              for p in range(size)]
    top = _largest(totals)
    coll = {k: int(round(per[f"collective_bytes/{k}"][top]))
            for k in COLLECTIVES if per[f"collective_bytes/{k}"][top]}
    return {
        "dot_flops": max(per["dot_flops"]),
        "collective_bytes": coll,
        "collective_total": int(sum(coll.values())),
        "collective_count": int(round(per["collective_count"][top])),
        "bytes_accessed": max(per["bytes_accessed"]),
        "memory": {k: int(round(max(per[k]))) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")},
        "positions": per,
        "out": out,
    }
