"""Placement layer: shard the engine's instance axis over a device mesh.

The PyTorch port of ``repro.solver.placement``.  ``engine.run_batch``
advances B colonies on one device; this is its multi-device route.  The
stack is padded to a multiple of the mesh's ``data`` size D, split into D
contiguous shards, and each shard runs the same ``run_batch`` body on its
position's device.  There is no traffic between positions inside the
loop: every instance's trajectory is local to its shard (the per-instance
freeze mask already makes trajectories independent of the batch around
them), each shard's loop ends when its own instances are done, and the
only communication is the final gather back onto the stack's device.

Uneven batches: when B is not a multiple of D the instance axis gains
**phantom slots** (row 0 of the problem and state replicated, budget 0),
which the engine's done mask freezes before the first step; the outputs
are sliced back to B rows, so callers never see them.

Exactness contract (tests/test_torch_mesh.py): sharded ``run_batch`` is
bitwise identical per instance to the single-device call for any D,
B % D != 0 and ``donate`` included, because each shard runs the same
per-slot arithmetic and the phantom slots never step.

The positions are driven in turn by this one process.  A shard's loop
reads the card only where the single-device loop does (the stagnation
counts under ``patience``, a local-search round's changed flag), so
shards on distinct cards overlap up to those reads.  Positions may repeat
a device: a 4-position mesh of one card runs the four shards one after
another on it.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree
from ..core import aco
from ..launch.mesh import Mesh, make_data_mesh
from . import engine


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D mesh over the host's first ``devices`` cards (all of them by
    default; ``ValueError`` past the cards there are), or over an explicit
    device list, where positions may repeat a device.  Built by a
    function, never at import time."""
    return make_data_mesh(devices, axis)


def device_label(device: Optional[torch.device], index: int) -> str:
    """Stable human-readable label for one mesh position: the Chrome trace
    *process* name of that position's streaming pools and the ``device``
    field of request-scoped lifecycle events.  ``device=None`` (the
    single-device route) stays the bare ``dev<i>``."""
    if device is None:
        return f"dev{index}"
    return f"dev{index}:{device.type}{device.index or 0}"


def _problem_map(fn, problem: aco.Problem) -> aco.Problem:
    """``fn`` over a stacked Problem's tensor leaves (dist, eta, nn and
    the Hyper's operands); the host ``n_actual`` tuple stays as it is."""
    dist, eta, nn, hyper = tree.map(
        fn, (problem.dist, problem.eta, problem.nn, problem.hyper))
    return problem._replace(dist=dist, eta=eta, nn=nn, hyper=hyper)


def pad_to_devices(problem: aco.Problem, states: aco.ColonyState,
                   budgets, since: torch.Tensor, multiple: int, mets=None):
    """Pad the instance axis to a multiple of ``multiple`` with phantom
    slots: row 0's problem and state replicated (host ``n_actual``
    included) with budget 0, which the engine's done mask freezes before
    the first step.  ``mets`` (metrics rows) pads the same way.  Returns
    the padded problem, states, budgets (a host list), since, mets and
    the original B; an even batch passes through untouched."""
    budgets = engine._host_ints(budgets)
    b = len(budgets)
    pad = (-b) % multiple
    if pad == 0:
        return problem, states, budgets, since, mets, b

    def rep(x):
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])

    problem = _problem_map(rep, problem)
    if problem.n_actual is not None:
        problem = problem._replace(
            n_actual=tuple(problem.n_actual) + (problem.n_actual[0],) * pad)
    states = tree.map(rep, states)
    since = torch.cat([since, torch.zeros((pad,), dtype=since.dtype,
                                          device=since.device)])
    if mets is not None:
        mets = tree.map(rep, mets)
    return problem, states, budgets + [0] * pad, since, mets, b


def _shard(problem, states, since, mets, lo: int, hi: int,
           dev: torch.device):
    """Rows [lo, hi) of the stacked operands on ``dev`` (views when they
    are there already)."""
    def take(x):
        return x[lo:hi].to(dev)
    p = _problem_map(take, problem)
    if problem.n_actual is not None:
        p = p._replace(n_actual=tuple(problem.n_actual[lo:hi]))
    return (p, tree.map(take, states), take(since),
            None if mets is None else tree.map(take, mets))


def run_batch_sharded(problem: aco.Problem, states: aco.ColonyState,
                      budgets, cfg: aco.ACOConfig, max_iters: int,
                      patience: int, since: Optional[torch.Tensor],
                      mesh: Mesh, instance_spec: str = "data",
                      donate: bool = False, mets=None):
    """Mesh route of ``engine.run_batch``: pad B to a multiple of the
    ``instance_spec`` axis, run one contiguous shard per position on its
    device, gather back onto the stack's device and slice to B.

    ``donate`` keeps the single-device contract: the caller's
    ``states``/``since``/``mets`` are updated in place and returned.
    Returns ``(states, since)``, plus the metrics rows with
    ``cfg.metrics``."""
    if instance_spec not in mesh.shape:
        raise ValueError(f"mesh has no axis {instance_spec!r}; "
                         f"axes: {tuple(mesh.shape)}")
    devs = mesh.axis_devices(instance_spec)
    home = states.key.device
    n_slots = states.key.shape[0]
    if since is None:
        since = torch.zeros((n_slots,), dtype=torch.int32, device=home)
    if not cfg.metrics:
        mets = None
    elif mets is None:
        from ..obs import metrics as obs_metrics
        mets = obs_metrics.zeros_batch(n_slots, home)
    held = (states, since, mets)
    p, s, bud, sn, mt, b = pad_to_devices(problem, states, budgets, since,
                                          len(devs), mets)
    per = len(bud) // len(devs)
    outs = []
    for j, dev in enumerate(devs):         # every shard dispatched in turn
        lo, hi = j * per, (j + 1) * per
        ps, ss, sns, mts = _shard(p, s, sn, mt, lo, hi, dev)
        outs.append(engine.run_batch(ps, ss, bud[lo:hi], cfg, max_iters,
                                     patience, sns, donate=donate,
                                     mets=mts))
    out = tuple(tree.map(lambda *xs: torch.cat([x.to(home) for x in xs])[:b],
                         *parts) for parts in zip(*outs))
    if donate:
        tree.map(lambda dst, src: dst.copy_(src), held[:len(out)], out)
        out = held[:len(out)]
    return out
