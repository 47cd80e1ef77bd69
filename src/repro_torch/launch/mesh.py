"""Device meshes: an array of ``torch.device`` positions with named axes.

The PyTorch port of ``repro.launch.mesh``.  The reference is
single-controller: one process drives every device of a
``jax.sharding.Mesh`` through ``shard_map``.  The port keeps that design.
A ``Mesh`` here is a NumPy object array of ``torch.device``s with one
name per axis; the work of each position runs on that position's device,
issued by this one process, and the collectives of ``core/collectives.py``
move tensors between the positions.

A position may repeat a device.  That is the counterpart of the
reference's forced host device count (``--xla_force_host_platform_
device_count``): a 4-position mesh of ``cpu`` runs the island model in
one process on the CPU, and a 4-position mesh of ``cuda:0`` runs it on
one card.

Meshes are built by functions, never at import time.  The reference's
``make_production_mesh`` and its TPU ``HW`` constants serve the TPU
dry-runs and the LM substrate and are not ported here.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

DevicesLike = Union[int, Sequence[Union[str, torch.device]], None]


class Mesh:
    """Named axes over an object array of ``torch.device`` positions.

    ``devices`` is anything ``np.array(..., dtype=object)`` turns into an
    array with one dimension per name in ``axis_names`` (a flat list for a
    1-D mesh); strings become ``torch.device``s.  ``shape`` maps each axis
    name to its size, in axis order, as the reference's ``Mesh.shape``.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        shape = np.asarray(devices, dtype=object).shape
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)}-D devices for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """Every position's device in row-major position order."""
        return list(self.devices.flat)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at coordinate 0 of every other axis:
        the positions a 1-D layout over that axis uses."""
        return self.submesh((axis,)).device_list()

    def submesh(self, axes: Sequence[str]) -> "Mesh":
        """The mesh over ``axes`` (in that order) at coordinate 0 of every
        other axis."""
        axes = tuple(axes)
        dims = [self.axis_names.index(a) for a in axes]
        idx = tuple(slice(None) if d in dims else 0
                    for d in range(self.devices.ndim))
        kept = sorted(dims)
        return Mesh(self.devices[idx].transpose(
            [kept.index(d) for d in dims]), axes)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list()]})")


def resolve_devices(devices: DevicesLike = None) -> list:
    """``None`` -> every card; an int -> the first that many cards
    (``ValueError`` past the cards there are, with the reference's
    message); a sequence -> those devices as given, repeats allowed."""
    if devices is not None and not isinstance(devices, (int, np.integer)):
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("requested 0 devices")
        return out
    avail = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    n = len(avail) if devices is None else int(devices)
    if not 1 <= n <= len(avail):
        raise ValueError(f"requested {n} devices, have {len(avail)}")
    return avail[:n]


def make_data_mesh(devices: DevicesLike = None, axis: str = "data") -> Mesh:
    """1-D instance-sharding mesh over ``devices`` (see
    ``resolve_devices``): the solver fabric's topology.  The placement
    layer (``solver/placement.py``) shards batch jobs' instance axes over
    its ``data`` axis, and the streaming service places one resident pool
    per position."""
    return Mesh(resolve_devices(devices), (axis,))


def make_mesh_for(devices: DevicesLike = None, model_parallel: int = 1,
                  pods: int = 1) -> Mesh:
    """Elastic mesh: whatever devices there are, factored (pods, dp, mp)
    with axes ("pod", "data", "model"), or ("data", "model") for one pod."""
    devs = resolve_devices(devices)
    n = len(devs)
    if n % (model_parallel * pods):
        raise ValueError(f"{n} devices do not factor into {pods} pods x "
                         f"model_parallel {model_parallel}")
    dp = n // (model_parallel * pods)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    if pods > 1:
        return Mesh(arr.reshape(pods, dp, model_parallel),
                    ("pod", "data", "model"))
    return Mesh(arr.reshape(dp, model_parallel), ("data", "model"))

