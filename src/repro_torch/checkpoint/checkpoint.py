"""Fault-tolerant checkpoints of the port's states: NamedTuples of tensors.

The PyTorch port of ``repro.checkpoint.checkpoint``:

- **Atomic**: write ``<path>.tmp``, then ``os.replace``; a checkpoint
  exists completely or not at all, and a job killed mid-write never
  corrupts the restore point.
- **Async**: ``CheckpointManager.save`` can hand the write to a background
  thread, one write in flight, so the solve is not blocked by the disk.
- **Self-describing**: the leaves' count and the raw dtypes are stored in
  the npz beside the data.  bfloat16 (which NumPy lacks) is stored as its
  raw 16 bits and comes back bit for bit.
- **On the template's device**: ``load_pytree`` puts each leaf where the
  template's leaf lives, so a state saved from the card restores onto the
  card.
- **Elastic restore**: ``restore_to_sharding`` puts each leaf on a target
  device, or splits stacked leaves one row per mesh position, so a
  checkpoint written on one mesh restarts on another; ``reshard_islands``
  re-splits stacked island states across a different island count.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import tree
from ..core import sampling

# torch dtypes NumPy has no type for: stored as raw bits of this width
_RAW = {torch.bfloat16: (torch.int16, np.int16)}
_RAW_BY_NAME = {str(k): (k, v[1]) for k, v in _RAW.items()}


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """A CPU copy the caller's later in-place updates cannot reach."""
    return x.detach().to("cpu", copy=True)


def _to_numpy(x: torch.Tensor) -> tuple[np.ndarray, Optional[str]]:
    x = x.detach().cpu()
    if x.dtype in _RAW:
        return x.view(_RAW[x.dtype][0]).numpy(), str(x.dtype)
    return x.numpy(), None


def save_pytree(path: str, state: Any, step: Optional[int] = None) -> None:
    """Atomic npz save of a tree of tensors (bfloat16 as raw bits, the true
    dtype recorded in the meta record)."""
    leaves = tree.flatten(state)
    arrs, raw = {}, {}
    for i, x in enumerate(leaves):
        a, name = _to_numpy(x)
        if name is not None:
            raw[str(i)] = name
        arrs[f"leaf_{i}"] = a
    meta = {"n_leaves": len(leaves), "step": step, "raw_dtypes": raw}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrs)
    os.replace(tmp, path)


def load_pytree(path: str, template: Any) -> Any:
    """Restore into ``template``'s structure, each leaf on the device of
    the template's leaf at the same position."""
    targets = tree.flatten(template)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["n_leaves"] != len(targets):
            raise ValueError(
                f"checkpoint {path} holds {meta['n_leaves']} tensors, the "
                f"template {len(targets)}")
        raw = meta.get("raw_dtypes", {})
        leaves = []
        for i, like in enumerate(targets):
            t = torch.from_numpy(np.array(z[f"leaf_{i}"]))
            if str(i) in raw:
                t = t.view(_RAW_BY_NAME[raw[str(i)]][0])
            leaves.append(t.to(like.device))
    return tree.unflatten(template, leaves)


def restore_to_sharding(path: str, template: Any, shardings: Any) -> Any:
    """Restore ``path`` in ``template``'s structure onto target devices.

    ``shardings`` is one device for every leaf, a tree like ``template``
    with one device per leaf, or a list of per-position devices: every
    leaf is then stacked with one row per position (island states), and
    the result is a list of per-position trees, row i on ``shardings[i]``.
    """
    host = load_pytree(path, tree.map(lambda x: x.to("cpu"), template))
    if isinstance(shardings, (str, torch.device)):
        return tree.map(lambda x: x.to(shardings), host)
    if isinstance(shardings, list) and shardings and all(
            isinstance(d, (str, torch.device)) for d in shardings) and \
            not isinstance(template, list):
        return [tree.map(lambda x: x[i].to(dev), host)
                for i, dev in enumerate(shardings)]
    devs = _device_leaves(shardings)
    leaves = tree.flatten(host)
    if len(devs) != len(leaves):
        raise ValueError(f"{len(devs)} shardings for {len(leaves)} leaves")
    return tree.unflatten(host, [x.to(d) for x, d in zip(leaves, devs)])


def _device_leaves(shardings: Any) -> list:
    """The device leaves of a tree of devices, in field order."""
    if isinstance(shardings, (str, torch.device)):
        return [torch.device(shardings)]
    if shardings is None:
        return []
    out = []
    for kid in shardings:
        out.extend(_device_leaves(kid))
    return out


def reshard_islands(state: Any, n_new: int) -> Any:
    """Elastically change the island count of a stacked ColonyState.

    Shrink: keep the best ``n_new`` islands (by ``best_len``, in NumPy's
    ``argsort`` order, as the reference).  Grow: tile the islands
    round-robin and decorrelate the copies' keys with ``fold_in(key, i)``
    for island i.
    """
    lens = state.best_len.cpu().numpy()
    n_old = lens.shape[0]
    if n_new <= n_old:
        keep = torch.as_tensor(np.argsort(lens)[:n_new],
                               device=state.best_len.device)
        return tree.map(lambda x: x[keep], state)
    reps = torch.tensor([i % n_old for i in range(n_new)],
                        device=state.best_len.device)
    out = tree.map(lambda x: x[reps], state)
    keys = torch.stack([sampling.fold_in(k, i)
                        for i, k in enumerate(out.key)])
    return out._replace(key=keys)


class CheckpointManager:
    """Step-numbered checkpoints with retention and optional async writes."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue[tuple[str, Any, int]]" = queue.Queue(maxsize=1)
        self._async = async_write
        self._err: Optional[BaseException] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:09d}.npz")

    def _worker(self) -> None:
        while True:
            path, state, step = self._q.get()
            try:
                save_pytree(path, state, step)
                self._gc()
            except BaseException as e:  # surfaced on the next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append(int(f[5:-4]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, step: int, state: Any) -> None:
        self._raise_pending()
        # copy to the host *now*, so the caller may update its state in
        # place while the write is in flight
        host = tree.map(_host_copy, state)
        if self._async:
            self._q.put((self._path(step), host, step))
        else:
            save_pytree(self._path(step), host, step)
            self._gc()

    def wait(self) -> None:
        if self._async:
            self._q.join()
        self._raise_pending()

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, int]:
        """The newest (or ``step``'s) checkpoint in ``template``'s
        structure, on its devices, or on ``shardings``
        (``restore_to_sharding``)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        if shardings is not None:
            return restore_to_sharding(path, template, shardings), step
        return load_pytree(path, template), step
