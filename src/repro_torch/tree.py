"""Nested NamedTuples of tensors: map, flatten and rebuild.

The port's states are NamedTuples of tensors, some nested (a quantised
tau is a ``QuantTau`` inside a ``ColonyState``), with None for an absent
field.  The batched engine stacks and slices them, and checkpoints store
their leaves; these helpers walk them in field order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _is_node(x: Any) -> bool:
    return isinstance(x, (tuple, list))


def _rebuild(template: Any, children: list) -> Any:
    if hasattr(template, "_fields"):          # a NamedTuple
        return type(template)(*children)
    return type(template)(children)


def map(fn: Callable, *trees: Any) -> Any:        # noqa: A001
    """``fn`` over corresponding tensor leaves of trees of one structure;
    None stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if _is_node(first):
        return _rebuild(first, [map(fn, *kids) for kids in zip(*trees)])
    if isinstance(first, dict):               # sorted keys, as jax.tree
        return {k: map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    raise TypeError(f"not a tree of tensors: {type(first).__name__}")


def flatten(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves in field order (None fields have none)."""
    out: list[torch.Tensor] = []
    map(lambda x: out.append(x), tree)
    return out


def unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` in its tensor positions."""
    it = iter(leaves)
    out = map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has tensors")
    return out


def stack(trees: list) -> Any:
    """Trees of one structure -> one tree with each leaf stacked on a new
    axis 0."""
    return map(lambda *xs: torch.stack(xs), *trees)


def index(tree: Any, i: int) -> Any:
    """Leaf ``[i]`` of every leaf: one slot's view of a stacked tree."""
    return map(lambda x: x[i], tree)
