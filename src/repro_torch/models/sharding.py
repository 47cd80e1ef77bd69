"""Partition rules and shards, the port of ``repro.models.sharding``:
``param_specs``, ``data_specs``, ``cache_specs``, ``to_shardings`` and the
activation-sharding context.

A spec is a tuple with one entry per tensor dimension: None (replicated),
a mesh axis name, or a tuple of two or more axis names (one name alone is
the name, as ``PartitionSpec`` writes it).  The rules are the
reference's, pure functions of the shapes and of ``mesh.shape`` (axes:
optional "pod", "data", "model"):

- ``model`` = tensor parallelism: attention heads (fallback: head_dim,
  then replicate), MLP d_ff, MoE experts (fallback: the expert-internal
  d_ff), Mamba inner channels / SSD heads, vocab (fallback: d_model when
  the vocab is not divisible, e.g. whisper's 51865);
- ``data`` = FSDP: the weight's d_model-like dimension;
- ``pod`` = plain data parallelism (batch), replicated parameters.

Every rule checks divisibility and falls back to replication.  The
reference stacks the periodic body and the encoder over a leading axis
and evaluates its rules on those stacked shapes; the port's layers are
unrolled, so each rule here reads the reference's stacked shape and the
period axis is dropped from the spec it gives (the decode cache's too).
Where a rule shards that period axis itself (a 2-D MLP or MLA ``wo``
stacked to 3-D matches the attention ``wo`` rule, so OLMo-1B's 16
periods split over ``model``), the spec is a ``HeldSpec``: layer i's
copy of the leaf is held whole along the period axis, its other axes as
the rule says, only on the positions whose coordinate over the period
entry's axes is ``p(i) // (P / parts)`` (p(i) its period index, P the
periods, parts the entry's size), as the reference's period chunk
places it; every other position holds an empty shard of it.

A ``Sharding`` (``to_shardings``) is the port's ``NamedSharding``: a mesh
of ``torch.device`` positions (``launch.mesh.Mesh``) and a spec.  A value
sharded over the mesh is a list of per-position tensors in row-major
position order (``core/collectives.py``); ``shard`` cuts a whole tensor
into that list and ``gather`` puts it back together.

The activation constraints (``constrain_tokens``,
``constrain_expert_batch``, ``constrain_combine``) are value identities,
as ``with_sharding_constraint`` is on values: the port's sharded step
places the batch itself (``launch/steps.py``).  Inside
``activation_sharding`` each call records the spec that the reference
would pin, with the reference's divisibility fallbacks.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..analysis import ops
from .config import ModelConfig


def axes_of(axis) -> tuple:
    """A spec entry's mesh axes: () for None, a 1-tuple for a name."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _entry(axes: tuple):
    """A spec entry for ``axes``: None, the one name, or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return n % int(np.prod([mesh.shape[a] for a in axes_of(axis)])) == 0


def _rule(path: str, shape: Sequence[int], mesh, fa, ma) -> tuple:
    """The reference's rule for the leaf at ``path`` ("/"-joined) of
    ``shape`` (its stacked shape in the reference's tree)."""
    nd = len(shape)
    name = path.rsplit("/", 1)[-1]
    in_moe = "/moe/" in path or path.endswith("moe")

    def fsdp(dim: int):
        return _entry(fa) if fa and dim and _div(dim, mesh, fa) else None

    def tp(dim: int):
        return (ma if ma and ma in mesh.shape and dim and _div(dim, mesh, ma)
                else None)

    def pad(spec: tuple) -> tuple:
        return (None,) * (nd - len(spec)) + spec

    # ---- embeddings / heads
    if name == "embed":
        v, d = shape[-2:]
        return pad((ma, fsdp(d))) if tp(v) else pad((None, tp(d)))
    if name == "lm_head":
        d, v = shape[-2:]
        return pad((fsdp(d), ma)) if tp(v) else pad((tp(d), None))

    # ---- attention (GQA)
    if name == "wq" and nd >= 3:
        d, h, dh = shape[-3:]
        if tp(h):
            return pad((fsdp(d), ma, None))
        if tp(dh):
            return pad((fsdp(d), None, ma))
        return pad((fsdp(d), None, None))
    if name in ("wk", "wv") and nd >= 3:
        d, kv, dh = shape[-3:]
        if tp(kv):
            return pad((fsdp(d), ma, None))
        return pad((fsdp(d), None, None))
    if name == "wo" and nd >= 3 and not in_moe:
        h, dh, d = shape[-3:]
        if tp(h):
            return pad((ma, None, fsdp(d)))
        if tp(dh):
            return pad((None, ma, fsdp(d)))
        return pad((None, None, fsdp(d)))

    # ---- MLA projections (2-D)
    if name in ("wq_a", "wkv_a"):
        d, r = shape[-2:]
        return pad((fsdp(d), tp(r)))
    if name in ("wq_b", "wkv_b"):
        r, hq = shape[-2:]
        return pad((fsdp(r), tp(hq)))
    if name == "wq" and nd == 2:        # MLA dense q
        d, hq = shape[-2:]
        return pad((fsdp(d), tp(hq)))
    if name == "wo" and nd == 2 and not in_moe:
        hv, d = shape[-2:]
        return pad((tp(hv), fsdp(d)))

    # ---- MoE
    if in_moe:
        if name == "router":
            return pad((None, None))
        if name in ("wi", "wg") and nd >= 3:
            e, d, f = shape[-3:]
            if tp(e):
                # FSDP on the ff dim, not on d (the reference's reason: a
                # d-sharded expert weight makes every expert product a
                # partial sum all-reduced over the data axis)
                return pad((ma, None, fsdp(f)))
            return pad((None, fsdp(d), tp(f)))
        if name == "wo" and nd >= 3:
            e, f, d = shape[-3:]
            if tp(e):
                return pad((ma, fsdp(f), None))
            return pad((None, tp(f), fsdp(d)))
        if name in ("shared_wi", "shared_wg"):
            d, f = shape[-2:]
            return pad((fsdp(d), tp(f)))
        if name == "shared_wo":
            f, d = shape[-2:]
            return pad((tp(f), fsdp(d)))

    # ---- dense MLP (2-D)
    if name in ("wi", "wg"):
        d, f = shape[-2:]
        return pad((fsdp(d), tp(f)))
    if name == "wo" and nd == 2:
        f, d = shape[-2:]
        return pad((tp(f), fsdp(d)))

    # ---- mamba
    if name == "in_proj":
        d, z = shape[-2:]
        return pad((fsdp(d), tp(z)))
    if name == "out_proj":
        din, d = shape[-2:]
        return pad((tp(din), fsdp(d)))
    if name == "conv_w":
        return pad((None, tp(shape[-1])))
    if name in ("conv_b", "norm_scale", "A_log", "D", "dt_bias"):
        return pad((tp(shape[-1]),))

    # ---- misc dense (mtp proj, enc_in_proj)
    if name in ("proj", "enc_in_proj"):
        a, b = shape[-2:]
        return pad((fsdp(a), tp(b)))

    # ---- norms & anything else: replicate
    return ()


class HeldSpec(tuple):
    """The spec of one layer of a stacked leaf whose period axis the
    reference's rule shards: the entries of the layer's own axes (as a
    tuple, it equals the plain spec with the period axis dropped), and
    ``held`` = (the period entry's axes, the chunk of them that holds
    this layer)."""

    def __new__(cls, spec: Sequence, held: tuple):
        out = super().__new__(cls, spec)
        out.held = held
        return out

    def __repr__(self) -> str:
        return f"HeldSpec({tuple(self)}, held={self.held})"


def param_specs(params: nn.Module, cfg: ModelConfig, mesh,
                fsdp_axis=("data",),
                model_axis: Optional[str] = "model") -> dict:
    """{parameter name: spec}, from the shapes only.  ``fsdp_axis`` may be
    one axis or a tuple (pure FSDP shards weights over both); model_axis
    None turns tensor parallelism off.  A layer of a leaf whose period
    axis the rule shards gets a ``HeldSpec``."""
    from . import model     # model.py imports this module
    fa = tuple(a for a in axes_of(fsdp_axis) if a in mesh.shape) or None
    out = {}
    for name, p in params.named_parameters():
        path, index, stack = model.reference_path(name, cfg)
        shape = ((stack,) if stack else ()) + tuple(p.shape)
        spec = _rule("/".join(map(str, path)), shape, mesh, fa, model_axis)
        if not (stack and len(spec) == len(shape)):
            out[name] = spec
        elif spec[0] is None:
            out[name] = spec[1:]
        else:
            axes = axes_of(spec[0])
            per = stack // int(np.prod([mesh.shape[a] for a in axes]))
            out[name] = HeldSpec(spec[1:], (axes, index // per))
    return out


def batch_axes(mesh) -> tuple:
    """Data-parallel axes for the batch dim: pod (if present) + data."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_specs(cfg: ModelConfig, mesh, batch: int,
               axes: Optional[Sequence[str]] = None) -> tuple:
    """Spec of (B, S) token batches: the batch over every axis of
    ``axes`` (default: the data-parallel axes, ``batch_axes``) that
    divides it."""
    keep: list = []
    rem = batch
    for a in batch_axes(mesh) if axes is None else axes:
        if rem % mesh.shape[a] == 0:
            keep.append(a)
            rem //= mesh.shape[a]
    return (_entry(tuple(keep)), None)


def cache_specs(caches: dict, cfg: ModelConfig, mesh, batch: int,
                shard_seq: bool = False) -> dict:
    """Decode-cache specs, in the cache's own structure (``{"layers":
    [...], "step"}``, ``model.init_cache``).  Default: the batch over the
    data-parallel axes, kv-heads over ``model`` when divisible.
    shard_seq=True (long context, batch 1): the cache's sequence axis
    over ``data``, the distributed flash-decode layout."""
    bspec = data_specs(cfg, mesh, batch)[0]
    n_model = mesh.shape["model"]

    def rule(name: str, shape) -> tuple:
        if name in ("len", "step") or len(shape) == 0:
            return ()
        if name in ("k", "v"):                    # (B, T, KV, dh)
            kvs = "model" if shape[-2] % n_model == 0 else None
            return ((None, "data", kvs, None) if shard_seq
                    else (bspec, None, kvs, None))
        if name == "ckv":                         # (B, T, rank)
            return (None, "data", None) if shard_seq else (bspec, None, None)
        if name == "k_rope":                      # (B, T, 1, rdim)
            return ((None, "data", None, None) if shard_seq
                    else (bspec, None, None, None))
        if name == "conv":                        # (B, K-1, conv_dim)
            return (bspec, None,
                    "model" if shape[-1] % n_model == 0 else None)
        if name == "h":                           # (B, H, P, N)
            return (bspec, "model" if shape[-3] % n_model == 0 else None,
                    None, None)
        return ()

    def walk(node, name: str):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return rule(name, tuple(node.shape))

    return walk(caches, "")


class Sharding:
    """The port's ``NamedSharding``: ``mesh`` (a ``launch.mesh.Mesh``) and
    ``spec``, which splits each dimension into equal chunks over the
    product of its axes; a position's chunk index along a dimension is
    its row-major coordinate over that dimension's axes, in the order the
    entry names them.  Positions whose chunks agree in every dimension
    hold copies of the same slice.  A ``HeldSpec``'s ``held`` (axes,
    chunk) limits the holders to the positions whose coordinate over
    those axes is that chunk; the others hold an empty shard (``shard``:
    dimension 0 of size 0).  On a mesh of ``meta`` positions it gives
    shapes only."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.held = getattr(spec, "held", None)
        self._distinct = None

    def __repr__(self) -> str:
        held = "" if self.held is None else f", held={self.held}"
        return f"Sharding({self.mesh.shape}, {self.spec}{held})"

    def holds(self, pos: int) -> bool:
        """Whether position ``pos`` holds a slice (not an empty shard)."""
        if self.held is None:
            return True
        axes, chunk = self.held
        coords = self.mesh.coords(pos)
        k = 0
        for a in axes:
            k = k * self.mesh.shape[a] + int(coords[a])
        return k == chunk

    def empty_shape(self, shape: Sequence[int]) -> tuple:
        """The shard shape of a position that holds nothing."""
        return (0,) + self.shard_shape(shape)[1:]

    def _parts(self, entry) -> int:
        return int(np.prod([self.mesh.shape[a] for a in axes_of(entry)]))

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The shape each position holds of a whole tensor of ``shape``."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} for a shape {shape}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = self._parts(entry)
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {shape} does not split "
                                 f"into {n} ({self.spec})")
            out[d] = shape[d] // n
        return tuple(out)

    def chunk(self, pos: int) -> tuple:
        """Position ``pos``'s chunk index along each dimension of the
        spec."""
        coords = self.mesh.coords(pos)
        out = []
        for entry in self.spec:
            k = 0
            for a in axes_of(entry):
                k = k * self.mesh.shape[a] + int(coords[a])
            out.append(k)
        return tuple(out)

    def slices(self, pos: int, shape: Sequence[int]) -> tuple:
        """Position ``pos``'s slice of a whole tensor of ``shape``."""
        part = self.shard_shape(shape)
        return tuple(slice(k * n, (k + 1) * n)
                     for k, n in zip(self.chunk(pos), part))

    def distinct(self) -> list[int]:
        """The first holder of each distinct chunk, in position order:
        where a replicated slice is counted once."""
        if self._distinct is None:
            seen: dict = {}
            for pos in range(self.mesh.size):
                if self.holds(pos):
                    seen.setdefault(self.chunk(pos), pos)
            self._distinct = list(seen.values())
        return list(self._distinct)

    def shard(self, t: torch.Tensor) -> list:
        """``t`` cut into each position's slice, a contiguous copy on that
        position's device (a replicated slice copied to every position
        holding it; an empty shard where a position holds nothing)."""
        devices = self.mesh.device_list()
        if t.device.type == "meta" and all(d.type == "meta" for d in devices):
            # shapes only (each position its own tensor all the same)
            held, empty = self.shard_shape(t.shape), self.empty_shape(t.shape)
            return [t.new_empty(held if self.holds(pos) else empty)
                    for pos in range(len(devices))]
        return [t[self.slices(pos, t.shape)].to(
            dev, memory_format=torch.contiguous_format, copy=True)
            if self.holds(pos) else
            t.new_empty(self.empty_shape(t.shape), device=dev)
            for pos, dev in enumerate(devices)]

    def whole_shape(self, shards: Sequence[torch.Tensor]) -> tuple:
        """The whole tensor's shape from the per-position ``shards``."""
        part = tuple(shards[self.distinct()[0]].shape)
        return tuple(n * (self._parts(self.spec[d]) if d < len(self.spec)
                          else 1) for d, n in enumerate(part))

    def gather(self, shards: Sequence[torch.Tensor],
               device) -> torch.Tensor:
        """The whole tensor on ``device`` from the per-position
        ``shards`` (each distinct slice read once)."""
        shape = self.whole_shape(shards)
        out = torch.empty(shape, dtype=shards[0].dtype, device=device)
        if out.device.type == "meta":
            # shapes only: the copies' bytes are reported, not dispatched
            ops.kernel([shards[pos] for pos in self.distinct()], [out])
            return out
        for pos in self.distinct():
            out[self.slices(pos, shape)] = shards[pos]
        return out


def to_shardings(specs: dict, mesh) -> dict:
    """{name: ``Sharding(mesh, spec)``} for {name: spec}."""
    return {name: Sharding(mesh, spec) for name, spec in specs.items()}


# --------------------------------------------------------------------------
# The activation-sharding context.  The reference pins the token stream to
# batch-over-data-parallel-axes inside its layer scan, and the MoE expert
# batch to batch x experts, so that GSPMD does not replicate the batch.
# The port's sharded step places the batch itself; here the constraints
# are value identities that record, inside the context, what the
# reference would pin.


@dataclasses.dataclass
class _ActContext:
    mesh: object
    batch_axes: tuple
    shards: int            # batch shards the activations seen are one of
    record: list


_ACT: contextvars.ContextVar[Optional[_ActContext]] = contextvars.ContextVar(
    "activation_sharding", default=None)
_MUTED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "activation_sharding_muted", default=False)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes_: Sequence[str], shards: int = 1):
    """Inside, every constraint records ``(function name, the global shape
    of its tensor, the spec the reference would pin)`` into the list this
    yields.  ``shards`` > 1 says that the tensors seen hold one of that
    many batch shards (the sharded train step's groups), so their global
    batch is ``shards`` times theirs."""
    record: list = []
    token = _ACT.set(_ActContext(mesh, tuple(batch_axes_), shards, record))
    try:
        yield record
    finally:
        _ACT.reset(token)


@contextlib.contextmanager
def not_recording():
    """No constraint is recorded inside (a checkpointed layer's
    recomputation in the backward repeats calls its forward recorded)."""
    token = _MUTED.set(True)
    try:
        yield
    finally:
        _MUTED.reset(token)


def _global_rows(ctx: _ActContext, x: torch.Tensor) -> int:
    return x.shape[0] * ctx.shards


def _batch_entry(ctx: _ActContext, rows: int):
    total = int(np.prod([ctx.mesh.shape[a] for a in ctx.batch_axes]))
    return _entry(ctx.batch_axes) if ctx.batch_axes and \
        rows % total == 0 else None


def _pin(ctx: _ActContext, name: str, x: torch.Tensor,
         spec: tuple) -> torch.Tensor:
    if not _MUTED.get():
        ctx.record.append((name, (_global_rows(ctx, x),) + tuple(
            x.shape[1:]), spec))
    return x


def constrain_expert_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, E, cap, d) expert-dispatch buffer: batch over the data-parallel
    axes, experts over ``model`` (the boundary whose reshard is the MoE
    all-to-all); unpinned when neither divides."""
    ctx = _ACT.get()
    if ctx is None or x.dim() != 4:
        return x
    espec = ("model" if "model" in ctx.mesh.shape
             and x.shape[1] % ctx.mesh.shape["model"] == 0 else None)
    bspec = _batch_entry(ctx, _global_rows(ctx, x))
    if bspec is None and espec is None:
        return x
    return _pin(ctx, "constrain_expert_batch", x, (bspec, espec, None, None))


def constrain_combine(x: torch.Tensor) -> torch.Tensor:
    """(B, E, cap, d) expert output before the combine: batch over the
    data-parallel axes, experts unsharded.  The reference measured it
    slower than what GSPMD derives and calls it nowhere; so does the
    port."""
    ctx = _ACT.get()
    if ctx is None or x.dim() != 4:
        return x
    return _pin(ctx, "constrain_combine", x, (
        _batch_entry(ctx, _global_rows(ctx, x)), None, None, None))


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """A (B, ...) activation: batch over the data-parallel axes (unpinned
    outside the context, without such axes, or when B does not
    divide)."""
    ctx = _ACT.get()
    if ctx is None or not ctx.batch_axes or x.dim() == 0:
        return x
    bspec = _batch_entry(ctx, _global_rows(ctx, x))
    if bspec is None:
        return x
    return _pin(ctx, "constrain_tokens", x,
                (bspec,) + (None,) * (x.dim() - 1))
