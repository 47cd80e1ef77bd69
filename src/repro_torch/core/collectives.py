"""Collectives across the positions of a ``launch.mesh.Mesh``, host-issued.

The port's counterpart of the ``jax.lax`` collectives that the
reference's ``shard_map`` bodies call (``ppermute``, ``psum``, ``pmean``,
``pmax``, ``pmin``, ``all_gather``, ``axis_index``).  The reference is one
process driving every device of its mesh, and so is the port: a value
"sharded" over a mesh is a list of per-position tensors, one per position
in row-major order, each on its own position's device, and a collective
is a handful of tensor operations that this process issues.  Nothing here
blocks on the device: every copy and reduction is queued, so positions on
distinct cards overlap, and no result is read back to the host.

``axis`` names one mesh axis or a tuple of them; the collective runs
within each *group*, the positions that differ only in those axes, in
row-major order over the named axes.

Reduction order, fixed: ``psum`` adds the group's members left to right,
``((x0 + x1) + x2) + ...``, on the first member's device; ``pmean`` is
that sum times ``float32(1 / D)``.  That is XLA's order on the CPU
(probed with ``shard_map`` over 2, 3, 4 and 8 forced host devices, jax
0.9.0: the sum bitwise the left-to-right sum, the mean bitwise the sum
times the float32 reciprocal, for D = 3 too, where dividing differs), so
the port's sums are bitwise the reference's.  ``pmax``/``pmin`` are exact
in any order.

The results may share storage with the inputs and with each other where
two positions share a device; callers treat them as read-only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import floatops

Axis = Union[str, Sequence[str]]


def _groups(axis: Axis, mesh, size: int) -> list[list[int]]:
    """The collective's groups over ``axis`` as lists of flat position
    indices (each in row-major order over the named axes)."""
    if mesh.size != size:
        raise ValueError(f"{size} values for a mesh of {mesh.size} "
                         "positions")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = [mesh.axis_names.index(a) for a in axes]
    other = [d for d in range(mesh.devices.ndim) if d not in dims]
    idx = np.arange(size).reshape(mesh.devices.shape)
    width = int(np.prod([mesh.devices.shape[d] for d in dims]))
    return [list(map(int, row))
            for row in idx.transpose(other + dims).reshape(-1, width)]


def axis_size(axis: Axis, mesh) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return int(np.prod([mesh.shape[a] for a in axes]))


def axis_index(axis: Axis, mesh) -> list[int]:
    """Each position's index within its group over ``axis``."""
    out = [0] * mesh.size
    for g in _groups(axis, mesh, mesh.size):
        for k, i in enumerate(g):
            out[i] = k
    return out


def _each_group(xs, axis, mesh, fn) -> list:
    out = list(xs)
    for g in _groups(axis, mesh, len(xs)):
        res = fn([xs[i] for i in g])
        for k, i in enumerate(g):
            out[i] = res[k] if isinstance(res, list) else \
                res.to(xs[i].device)
    return out


def _fold(members: list, op) -> torch.Tensor:
    dev = members[0].device
    acc = members[0]
    for x in members[1:]:
        acc = op(acc, x.to(dev))
    return acc


def psum(xs: Sequence[torch.Tensor], axis: Axis, mesh) -> list:
    """Sum within each group, left to right."""
    return _each_group(xs, axis, mesh, lambda ms: _fold(ms, torch.add))


def pmean(xs: Sequence[torch.Tensor], axis: Axis, mesh) -> list:
    """The group's ``psum`` times ``float32(1 / D)``."""
    def mean(ms):
        s = _fold(ms, torch.add)
        return s * floatops.const(float(np.float32(1.0) / np.float32(
            len(ms))), s)
    return _each_group(xs, axis, mesh, mean)


def pmax(xs: Sequence[torch.Tensor], axis: Axis, mesh) -> list:
    return _each_group(xs, axis, mesh, lambda ms: _fold(ms, torch.maximum))


def pmin(xs: Sequence[torch.Tensor], axis: Axis, mesh) -> list:
    return _each_group(xs, axis, mesh, lambda ms: _fold(ms, torch.minimum))


def all_gather(xs: Sequence[torch.Tensor], axis: Axis, mesh) -> list:
    """Each position gets its group's values stacked on a new axis 0."""
    return _each_group(xs, axis, mesh, lambda ms: torch.stack(
        [x.to(ms[0].device) for x in ms]))


def ppermute(xs: Sequence[torch.Tensor], axis: Axis,
             perm: Sequence[tuple[int, int]], mesh) -> list:
    """``(src, dst)`` pairs of group indices: position ``dst`` of each
    group receives position ``src``'s value (a ring when ``perm`` is one);
    a position that receives nothing gets zeros, as in the reference."""
    def move(ms):
        got: list[Optional[torch.Tensor]] = [None] * len(ms)
        for src, dst in perm:
            got[dst] = ms[src].to(ms[dst].device)
        return [torch.zeros_like(ms[k]) if g is None else g
                for k, g in enumerate(got)]
    return _each_group(xs, axis, mesh, move)
