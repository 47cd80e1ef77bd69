"""Partition rules, the part of ``repro.models.sharding`` that the trainer
needs: ``param_specs``, ``data_specs`` and ``to_shardings``.

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
period axis is dropped from the spec it gives.

``to_shardings`` places every tensor on the device of a one-position
mesh.  Placing shards over more positions, the activation constraints
and the cache specs are ROADMAP item 18.6.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from torch import nn

from . import model
from .config import ModelConfig

SHARDING_ITEM = "ROADMAP item 18.6 (sharding)"


def _tup(axis) -> tuple:
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
    return n % int(np.prod([mesh.shape[a] for a in _tup(axis)])) == 0


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


def param_specs(params: nn.Module, cfg: ModelConfig, mesh,
                fsdp_axis=("data",),
                model_axis: Optional[str] = "model") -> dict:
    """{parameter name: spec}, from the shapes only.  ``fsdp_axis`` may be
    one axis or a tuple (pure FSDP shards weights over both); model_axis
    None turns tensor parallelism off."""
    fa = tuple(a for a in _tup(fsdp_axis) if a in mesh.shape) or None
    out = {}
    for name, p in params.named_parameters():
        path, _, stack = model.reference_path(name, cfg)
        shape = ((stack,) if stack else ()) + tuple(p.shape)
        spec = _rule("/".join(map(str, path)), shape, mesh, fa, model_axis)
        out[name] = spec[1:] if stack and len(spec) == len(shape) else spec
    return out


def batch_axes(mesh) -> tuple:
    """Data-parallel axes for the batch dim: pod (if present) + data."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_specs(cfg: ModelConfig, mesh, batch: int) -> tuple:
    """Spec of (B, S) token batches: the batch over every data-parallel
    axis that divides it."""
    keep: list = []
    rem = batch
    for a in batch_axes(mesh):
        if rem % mesh.shape[a] == 0:
            keep.append(a)
            rem //= mesh.shape[a]
    return (_entry(tuple(keep)), None)


def to_shardings(specs: dict, mesh) -> dict:
    """{name: the device its tensor lives on}: every tensor on the device
    of a one-position mesh.  More positions raise NotImplementedError
    (``SHARDING_ITEM``)."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"to_shardings over a {mesh.size}-position mesh {mesh.shape}: "
            f"{SHARDING_ITEM}")
    dev = mesh.device_list()[0]
    return {name: dev for name in specs}
