"""Carry a colony across between the JAX package and this port.

The reference's ``Problem``/``ColonyState`` are handed over as NumPy
arrays (``np.asarray`` of each field), so this module needs no JAX.  Both
packages can then compute from the same state, which is how the parity
tests hold the port to the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import device as _device
from .core import aco


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


def state_from_numpy(tau, best_tour, best_len, iteration, key,
                     device: _device.DeviceLike = None) -> aco.ColonyState:
    """Reference ``ColonyState`` fields (NumPy; ``key`` the raw uint32[2])
    -> the port's ``ColonyState``."""
    dev = _device.resolve(device)
    return aco.ColonyState(
        tau=torch.tensor(np.asarray(tau, np.float32), device=dev),
        best_tour=torch.tensor(np.asarray(best_tour, np.int32),
                                  device=dev),
        best_len=torch.tensor(np.asarray(best_len, np.float32),
                                 device=dev),
        iteration=torch.tensor(np.asarray(iteration, np.int32),
                                  device=dev),
        key=torch.tensor(np.asarray(key, np.uint32).astype(np.int64),
                            device=dev),
    )


def state_to_numpy(state: aco.ColonyState) -> dict:
    """The port's state as NumPy arrays, in the reference's dtypes."""
    return {
        "tau": state.tau.cpu().numpy(),
        "best_tour": state.best_tour.cpu().numpy(),
        "best_len": state.best_len.cpu().numpy(),
        "iteration": state.iteration.cpu().numpy(),
        "key": state.key.cpu().numpy().astype(np.uint32),
    }


def problem_to_numpy(problem: aco.Problem) -> dict:
    out = {"dist": problem.dist.cpu().numpy(),
           "eta": problem.eta.cpu().numpy(),
           "nn": problem.nn.cpu().numpy()}
    n_act: Optional[int] = problem.n_actual
    if n_act is not None:
        out["n_actual"] = np.int32(n_act)
    return out
