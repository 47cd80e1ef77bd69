"""A model's parameters held only as their shards over a mesh, and the
per-layer gathers that run it (ZeRO-3 style).

The reference places every parameter with a ``NamedSharding`` of its
``param_specs`` spec and lets GSPMD all-gather each layer's weights
inside the scan ("all-gathered per layer inside the scan (ZeRO-3
style)", ``repro.models.sharding``).  The port does the same by hand, in
its single-controller design (``launch/mesh.py``): a ``ShardedModel``
keeps, for every parameter, one tensor per mesh position (its
``Sharding.shard`` slice, on that position's device), and nothing whole.

``ShardedModel.view(device)`` gives a ``Model`` on the ``meta`` device
that runs on ``device``: its parameters outside the layers (embedding,
head, final norms, projections) are gathered there once, and each layer
gathers its own weights from their shards when it is called and drops
them when it returns.  Under a checkpoint (``remat``) the backward calls
the layer again, so it gathers again.  A gather is differentiable: its
backward hands each position the slice of the gradient that it holds, and
the positions' gradients accumulate across the data-parallel groups'
backward passes, run one after another in position order (the sum of
``collectives.psum``, then the slice each position holds).
"""
from __future__ import annotations

import contextlib
import torch
from torch import nn

from . import model
from .config import ModelConfig
from .sharding import Sharding, to_shardings


class _Gather(torch.autograd.Function):
    """The whole tensor on ``device`` from its per-position shards; the
    backward returns each position its slice of the gradient, on its
    device."""

    @staticmethod
    def forward(ctx, sharding: Sharding, device, *shards):
        ctx.sharding = sharding
        with torch.profiler.record_function("shard.gather"):
            return sharding.gather(shards, device)

    @staticmethod
    def backward(ctx, grad):
        sh = ctx.sharding
        with torch.profiler.record_function("shard.reduce"):
            out = tuple(grad[sh.slices(pos, grad.shape)].to(
                dev, memory_format=torch.contiguous_format, copy=True)
                for pos, dev in enumerate(sh.mesh.device_list()))
        return (None, None) + out


@contextlib.contextmanager
def _swapped(module: nn.Module, tensors: dict):
    """``module``'s parameters named in ``tensors`` (dotted names below
    it) replaced by those tensors while inside."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield module
    finally:
        for sub, leaf, p in reversed(saved):
            sub._parameters[leaf] = p


class _GatheredLayer(nn.Module):
    """A ``model.Layer`` of the meta skeleton that gathers its weights
    onto its input's device for each call."""

    def __init__(self, layer: model.Layer, prefix: str,
                 owner: "ShardedModel"):
        super().__init__()
        self.layer = layer
        self.spec = layer.spec
        self._names = [n for n, _ in layer.named_parameters()]
        self._prefix = prefix
        self._owner = owner

    def forward(self, x: torch.Tensor, *args, **kwargs):
        full = {n: self._owner.gathered(self._prefix + n, x.device)
                for n in self._names}
        with _swapped(self.layer, full):
            return self.layer(x, *args, **kwargs)


class ShardedModel:
    """``cfg``'s parameters over ``mesh``: ``shards[name]`` is the list
    of per-position tensors of parameter ``name`` (``shardings[name]``,
    from ``specs``), in row-major position order.  ``meta`` is the model
    on the ``meta`` device (names, shapes, reference leaves)."""

    def __init__(self, cfg: ModelConfig, mesh, specs: dict, shards: dict):
        self.cfg = cfg
        self.mesh = mesh
        self.specs = dict(specs)
        self.shardings = to_shardings(self.specs, mesh)
        self.shards = shards
        self.meta = model.Model(cfg, None, torch.device("meta"))
        self._skeleton = None

    @classmethod
    def from_model(cls, params: model.Model, mesh,
                   specs: dict) -> "ShardedModel":
        """``params`` cut into shards (``params`` itself is left as it
        is; drop it to hold only the shards)."""
        out = cls(params.cfg, mesh, specs, {})
        with torch.no_grad():
            out.shards = {name: out.shardings[name].shard(p.detach())
                          for name, p in params.named_parameters()}
        return out

    @property
    def root(self) -> torch.device:
        """The first position's device."""
        return self.mesh.device_list()[0]

    def gathered(self, name: str, device) -> torch.Tensor:
        """Parameter ``name`` whole on ``device``, differentiable back to
        its shards."""
        return _Gather.apply(self.shardings[name], torch.device(device),
                             *self.shards[name])

    def to_model(self, device) -> model.Model:
        """The whole model on ``device``."""
        out = model.Model(self.cfg, None, torch.device(device))
        whole = self.whole(self.shards, device)
        with torch.no_grad():
            for name, p in out.named_parameters():
                p.copy_(whole[name])
        return out

    def whole(self, shards: dict, device) -> dict:
        """{name: the whole tensor on ``device``} of tensors held in these
        parameters' shards (the parameters' own, or the moments')."""
        return {name: self.shardings[name].gather(s, device)
                for name, s in shards.items()}

    def position_bytes(self) -> list[int]:
        """The parameter bytes each position holds."""
        out = [0] * self.mesh.size
        for shards in self.shards.values():
            for pos, s in enumerate(shards):
                out[pos] += s.numel() * s.element_size()
        return out

    def _build_skeleton(self) -> tuple[model.Model, list]:
        """The meta model with each layer wrapped in a gathering one, and
        the names of the parameters outside the layers."""
        skel = model.Model(self.cfg, None, torch.device("meta"))
        wrapped = []
        for prefix, layers in (("prefix", skel.prefix),
                               ("blocks", skel.blocks),
                               ("enc_blocks", getattr(skel, "enc_blocks",
                                                      ()))):
            for i, layer in enumerate(layers):
                layers[i] = _GatheredLayer(layer, f"{prefix}.{i}.", self)
                wrapped.append(layers[i])
        if skel.mtp is not None:
            skel.mtp.block = _GatheredLayer(skel.mtp.block, "mtp.block.",
                                            self)
            wrapped.append(skel.mtp.block)
        inner = {w._prefix + n for w in wrapped for n in w._names}
        return skel, [name for name in self.shards if name not in inner]

    @contextlib.contextmanager
    def view(self, device):
        """A ``Model`` to run on ``device`` while inside: the parameters
        outside the layers gathered there, each layer gathering its own
        when called."""
        if self._skeleton is None:
            self._skeleton = self._build_skeleton()
        skel, outer = self._skeleton
        with _swapped(skel, {name: self.gathered(name, device)
                             for name in outer}):
            yield skel
