"""Carry a colony across between the JAX package and this port.

The reference's ``Problem``/``ColonyState`` and its sparse
``SparseProblem``/``SparseColonyState`` are handed over as NumPy arrays
(``np.asarray`` of each field), so this module needs no JAX.  Both
packages can then compute from the same state, which is how the parity
tests hold the port to the reference.

A quantised tau or overflow page (``QuantTau``) crosses as its three
arrays ``(q, scale, err)``.  NumPy has no bfloat16 of its own, so a bf16
payload travels as its raw 16 bits: any 2-byte payload array (the
reference's ``bfloat16``, or ``int16`` holding the bits) comes in as
``torch.bfloat16``, and ``state_to_numpy`` gives the payload back as
``int16`` bits.

The stacked counterparts carry a batch of the reference's solver across:
``problem_batch_from_numpy`` (a ``ProblemBatch.problem``: fields (B, ...),
``n_actual`` (B,) becoming the port's host tuple), ``states_from_numpy`` /
``states_to_numpy`` (a dense or sparse state stack, leaves (B, ...)) and
``metrics_to_numpy`` (StepMetrics rows).  Stacked island states (leading
island axis) cross as any other stack.  The city-sharded colony's state
crosses with its full (n, n) tau: ``sharded_state_from_numpy`` splits it
into the mesh positions' column slabs, ``sharded_state_to_numpy`` joins
them back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import device as _device
from .core import aco, islands, quant
from .obs import metrics as obs_metrics
from .sparse import store


def problem_from_numpy(dist, eta, nn, n_actual=None,
                       device: _device.DeviceLike = None) -> aco.Problem:
    """Reference ``Problem`` fields (NumPy) -> the port's ``Problem``."""
    dev = _device.resolve(device)
    return aco.Problem(
        dist=torch.tensor(np.asarray(dist, np.float32), device=dev),
        eta=torch.tensor(np.asarray(eta, np.float32), device=dev),
        nn=torch.tensor(np.asarray(nn, np.int32), device=dev),
        n_actual=None if n_actual is None else int(np.asarray(n_actual)),
    )


def _tau_from_numpy(tau, dev: torch.device):
    """An fp32 array, or a ``(q, scale, err)`` triple -> ``QuantTau``."""
    if not isinstance(tau, tuple):
        return torch.tensor(np.asarray(tau, np.float32), device=dev)
    q, scale, err = (np.asarray(x) for x in tau)
    if q.dtype.itemsize == 2:              # bfloat16 bits
        payload = torch.from_numpy(np.array(q).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    else:
        payload = torch.tensor(q.astype(np.int8), device=dev)
    return quant.QuantTau(
        q=payload,
        scale=torch.tensor(np.asarray(scale, np.float32), device=dev),
        err=torch.tensor(np.asarray(err, np.float32), device=dev))


def state_from_numpy(tau, best_tour, best_len, iteration, key,
                     device: _device.DeviceLike = None) -> aco.ColonyState:
    """Reference ``ColonyState`` fields (NumPy; ``key`` the raw uint32[2];
    a quantised ``tau`` as its ``(q, scale, err)`` arrays) -> the port's
    ``ColonyState``."""
    dev = _device.resolve(device)
    return aco.ColonyState(
        tau=_tau_from_numpy(tau, dev),
        best_tour=torch.tensor(np.asarray(best_tour, np.int32),
                                  device=dev),
        best_len=torch.tensor(np.asarray(best_len, np.float32),
                                 device=dev),
        iteration=torch.tensor(np.asarray(iteration, np.int32),
                                  device=dev),
        key=torch.tensor(np.asarray(key, np.uint32).astype(np.int64),
                            device=dev),
    )


def _tau_to_numpy(tau):
    """fp32 tau -> array; ``QuantTau`` -> ``(q, scale, err)``, a bf16
    payload as int16 bits."""
    if not isinstance(tau, quant.QuantTau):
        return tau.cpu().numpy()
    q = tau.q.cpu()
    if q.dtype == torch.bfloat16:
        q = q.view(torch.int16)
    return (q.numpy(), tau.scale.cpu().numpy(), tau.err.cpu().numpy())


def state_to_numpy(state: aco.ColonyState) -> dict:
    """The port's state as NumPy arrays, in the reference's dtypes; a
    quantised tau as a ``(q, scale, err)`` tuple, bf16 payload as int16
    bits."""
    return {
        "tau": _tau_to_numpy(state.tau),
        "best_tour": state.best_tour.cpu().numpy(),
        "best_len": state.best_len.cpu().numpy(),
        "iteration": state.iteration.cpu().numpy(),
        "key": state.key.cpu().numpy().astype(np.uint32),
    }


def sharded_state_from_numpy(tau, best_tour, best_len, iteration, key,
                             mesh, axis: str = "model"
                             ) -> islands.ShardedColonyState:
    """Reference ``ShardedColonyState`` fields (``tau`` the full (n, n)
    matrix) -> the port's, tau split into per-position column slabs, the
    replicated fields on the mesh's first position."""
    home = mesh.device_list()[0]
    st = state_from_numpy(tau, best_tour, best_len, iteration, key,
                          device=home)
    return islands.ShardedColonyState(
        islands.shard_columns(st.tau, mesh, axis), st.best_tour,
        st.best_len, st.iteration, st.key)


def sharded_state_to_numpy(state: islands.ShardedColonyState, mesh,
                           axis: str = "model") -> dict:
    """The port's city-sharded state as NumPy arrays, tau joined back to
    the full (n, n) matrix."""
    return state_to_numpy(aco.ColonyState(
        islands.unshard_columns(state.tau, mesh, axis), state.best_tour,
        state.best_len, state.iteration, state.key))


def problem_to_numpy(problem: aco.Problem) -> dict:
    out = {"dist": problem.dist.cpu().numpy(),
           "eta": problem.eta.cpu().numpy(),
           "nn": problem.nn.cpu().numpy()}
    n_act: Optional[int] = problem.n_actual
    if n_act is not None:
        out["n_actual"] = np.int32(n_act)
    return out


def sparse_problem_from_numpy(coords, cand, cand_dist, cand_eta,
                              n_actual=None,
                              device: _device.DeviceLike = None
                              ) -> store.SparseProblem:
    """Reference ``SparseProblem`` fields (NumPy) -> the port's."""
    dev = _device.resolve(device)
    return store.SparseProblem(
        coords=torch.tensor(np.asarray(coords, np.float32), device=dev),
        cand=torch.tensor(np.asarray(cand, np.int32), device=dev),
        cand_dist=torch.tensor(np.asarray(cand_dist, np.float32), device=dev),
        cand_eta=torch.tensor(np.asarray(cand_eta, np.float32), device=dev),
        n_actual=None if n_actual is None else int(np.asarray(n_actual)),
    )


def sparse_state_from_numpy(tau, tau_def, ovf_city, ovf_tau, best_tour,
                            best_len, iteration, key,
                            device: _device.DeviceLike = None
                            ) -> store.SparseColonyState:
    """Reference ``SparseColonyState`` fields (NumPy; a quantised ``tau`` or
    ``ovf_tau`` as its ``(q, scale, err)`` arrays) -> the port's."""
    dev = _device.resolve(device)
    dense = state_from_numpy(tau, best_tour, best_len, iteration, key, dev)
    return store.SparseColonyState(
        tau=dense.tau,
        tau_def=torch.tensor(np.asarray(tau_def, np.float32), device=dev),
        ovf_city=torch.tensor(np.asarray(ovf_city, np.int32), device=dev),
        ovf_tau=_tau_from_numpy(ovf_tau, dev),
        best_tour=dense.best_tour, best_len=dense.best_len,
        iteration=dense.iteration, key=dense.key)


def sparse_state_to_numpy(state: store.SparseColonyState) -> dict:
    """The port's sparse state as NumPy arrays, in the reference's dtypes
    (quantised pages as ``(q, scale, err)``)."""
    out = state_to_numpy(aco.ColonyState(state.tau, state.best_tour,
                                         state.best_len, state.iteration,
                                         state.key))
    out.update(tau_def=state.tau_def.cpu().numpy(),
               ovf_city=state.ovf_city.cpu().numpy(),
               ovf_tau=_tau_to_numpy(state.ovf_tau))
    return out


def sparse_problem_to_numpy(problem: store.SparseProblem) -> dict:
    out = {f: getattr(problem, f).cpu().numpy()
           for f in ("coords", "cand", "cand_dist", "cand_eta")}
    if problem.n_actual is not None:
        out["n_actual"] = np.int32(problem.n_actual)
    return out


def problem_batch_from_numpy(dist, eta, nn, n_actual, hyper=None,
                             device: _device.DeviceLike = None
                             ) -> aco.Problem:
    """A reference ``ProblemBatch.problem`` (fields (B, ...), ``n_actual``
    (B,); ``hyper`` its stacked ``(alpha, beta, rho, q)`` or None) -> the
    port's stacked ``Problem`` with ``n_actual`` a host tuple."""
    dev = _device.resolve(device)
    h = None
    if hyper is not None:
        h = aco.Hyper(*(torch.tensor(np.asarray(x, np.float32), device=dev)
                        for x in hyper))
    return aco.Problem(
        dist=torch.tensor(np.asarray(dist, np.float32), device=dev),
        eta=torch.tensor(np.asarray(eta, np.float32), device=dev),
        nn=torch.tensor(np.asarray(nn, np.int32), device=dev),
        n_actual=tuple(int(x) for x in np.asarray(n_actual)),
        hyper=h)


def states_from_numpy(device: _device.DeviceLike = None, **fields):
    """A reference state stack's fields (NumPy, leaves (B, ...); keys
    (B, 2) uint32; quantised pages as ``(q, scale, err)``) -> the port's
    stacked ``ColonyState``, or ``SparseColonyState`` when the fields hold
    ``tau_def``."""
    if "tau_def" in fields:
        return sparse_state_from_numpy(device=device, **fields)
    return state_from_numpy(device=device, **fields)


def states_to_numpy(states) -> dict:
    """The port's dense or sparse state stack as NumPy arrays, in the
    reference's dtypes."""
    if isinstance(states, store.SparseColonyState):
        return sparse_state_to_numpy(states)
    return state_to_numpy(states)


def metrics_to_numpy(mets) -> dict:
    """StepMetrics (scalar, (B,) rows or stacked over iterations) -> a dict
    of NumPy arrays by field."""
    return {f: v.cpu().numpy()
            for f, v in zip(obs_metrics.StepMetrics._fields, mets)}
