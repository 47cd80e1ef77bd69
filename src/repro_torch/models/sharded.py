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
``collectives.psum``, then the slice each position holds).  A layer of a
leaf whose period axis the reference shards is held by its period
chunk's positions only (``sharding.HeldSpec``); the others hold an empty
shard of it and get no gradient for it.

``ShardedCache`` holds a decode cache the same way, in the shards of
``sharding.cache_specs``; a layer given a ``LayerCache`` gathers its
group's rows of it and writes them back (the sharded decode step).
"""
from __future__ import annotations

import contextlib
import torch
from torch import nn

from ..analysis import ops
from . import model
from .config import ModelConfig
from .sharding import Sharding, to_shardings


class _Gather(torch.autograd.Function):
    """The whole tensor on ``device`` from its per-position shards; the
    backward returns each position its slice of the gradient, on its
    device (None where a position holds nothing of it).  Inside an
    ``analysis.ops`` accumulator the forward reports an all-gather (the
    whole tensor, on the position the work is attributed to) and the
    backward a reduce-scatter (each position's slice; a traced group
    that stands for others, ``ops.folded``, delivers it for each)."""

    @staticmethod
    def forward(ctx, sharding: Sharding, device, *shards):
        ctx.sharding = sharding
        with torch.profiler.record_function("shard.gather"):
            out = sharding.gather(shards, device)
        ops.collective("all-gather", [(ops.here()[0], ops.nbytes(out))])
        return out

    @staticmethod
    def backward(ctx, grad):
        sh = ctx.sharding
        out, sizes = [], []
        times = ops.folded()
        with torch.profiler.record_function("shard.reduce"):
            for pos, dev in enumerate(sh.mesh.device_list()):
                if not (sh.holds(pos) and ops.runs(pos)):
                    out.append(None)
                    continue
                with ops.at_position(pos, weight=times):
                    g = grad[sh.slices(pos, grad.shape)].to(
                        dev, memory_format=torch.contiguous_format,
                        copy=True)
                out.append(g)
                sizes.append((pos, ops.nbytes(g) * times))
        ops.collective("reduce-scatter", sizes)
        return (None, None) + tuple(out)


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
        args = list(args)
        held = {k: a for k, a in enumerate(args)
                if isinstance(a, LayerCache)}
        for k, cache in held.items():
            args[k] = cache.gather(x.device)
        with _swapped(self.layer, full):
            out = self.layer(x, *args, **kwargs)
        for cache in held.values():
            cache.write(out[1])
            out = (out[0], cache) + tuple(out[2:])
        return out


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


# ---------------------------------------------------------------- caches
def _leaves(tree: dict, path: tuple = ()):
    """(path, leaf) of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class ShardedCache:
    """A decode cache (``model.init_cache``'s {"layers", "step"}) held
    in shards over ``mesh``: ``layers[i]`` is layer i's cache tree with,
    at each leaf, its per-position tensors (``Sharding.shard`` by the
    leaf's ``cache_specs`` spec in ``shardings``); ``step`` stays whole
    on the first position's device.  The sharded decode step
    (``launch/steps.py``) gives each layer a ``LayerCache``: the layer
    gathers its data-parallel group's rows onto its device, updates them,
    and writes each position's slices back in place."""

    def __init__(self, mesh, specs: dict, layers: list, step: torch.Tensor):
        self.mesh = mesh
        self.specs = specs
        self.layers = layers
        self.step = step
        self.shardings = [
            {path: Sharding(mesh, spec) for path, spec in _leaves(ls)}
            for ls in specs["layers"]]

    @classmethod
    def from_cache(cls, caches: dict, mesh, specs: dict) -> "ShardedCache":
        """``caches`` (whole, on any device) cut into shards."""
        layers = []
        for c, sp in zip(caches["layers"], specs["layers"]):
            tree: dict = {}
            for path, t in _leaves(c):
                _put(tree, path, Sharding(mesh, _at(sp, path)).shard(t))
            layers.append(tree)
        return cls(mesh, specs, layers,
                   caches["step"].to(mesh.device_list()[0], copy=True))

    @property
    def shards(self) -> list:
        """Every leaf's per-position list (what a position holds)."""
        return [v for ls in self.layers for _, v in _leaves(ls)]

    def whole(self, device) -> dict:
        """The cache whole on ``device`` (``model.init_cache``'s form)."""
        layers = []
        for ls, shs in zip(self.layers, self.shardings):
            tree: dict = {}
            for path, shards in _leaves(ls):
                _put(tree, path, shs[path].gather(shards, device))
            layers.append(tree)
        return {"layers": layers, "step": self.step.to(device)}


class LayerCache:
    """Layer ``i`` of a ``ShardedCache`` as one data-parallel group sees
    it: the batch ``rows`` of the group whose positions are ``members``.
    ``gather`` assembles those rows of every leaf on a device (each
    distinct slice read once; a 0-d leaf, the fill count, from the
    group's first position), ``write`` puts a layer's new cache back:
    the rows into every position whose slice holds them, the 0-d leaves
    into the group's own positions.  Inside an ``analysis.ops``
    accumulator the gather is an all-gather on the position the work is
    attributed to and the write-back a collective-permute to each
    position written."""

    def __init__(self, owner: ShardedCache, i: int, rows: slice,
                 members: list):
        self.owner = owner
        self.i = i
        self.rows = rows
        self.members = members

    def _parts(self, sh: Sharding, shards: list, positions) -> list:
        """(position, its whole-tensor slices, the rows it shares with
        the group's, lo, hi) for each position whose slice meets them."""
        shape = sh.whole_shape(shards)
        out = []
        for q in positions:
            sl = sh.slices(q, shape)
            lo, hi = max(sl[0].start, self.rows.start), \
                min(sl[0].stop, self.rows.stop)
            if lo < hi:
                out.append((q, sl, lo, hi))
        return out

    def gather(self, device) -> dict:
        device = torch.device(device)
        tree: dict = {}
        here, total = ops.here()[0], 0
        for path, shards in _leaves(self.owner.layers[self.i]):
            sh = self.owner.shardings[self.i][path]
            if shards[0].dim() == 0:
                _put(tree, path, shards[self.members[0]].to(device))
                continue
            shape = sh.whole_shape(shards)
            r0 = self.rows.start
            out = torch.empty((self.rows.stop - r0,) + tuple(shape[1:]),
                              dtype=shards[0].dtype, device=device)
            parts = self._parts(sh, shards, sh.distinct())
            if device.type == "meta":
                ops.kernel([shards[q] for q, *_ in parts], [out])
            else:
                for q, sl, lo, hi in parts:
                    out[(slice(lo - r0, hi - r0),) + sl[1:]] = \
                        shards[q][lo - sl[0].start:hi - sl[0].start]
            total += ops.nbytes(out)
            _put(tree, path, out)
        ops.collective("all-gather", [(here, total)])
        return tree

    def write(self, new: dict) -> None:
        mesh = self.owner.mesh
        devices = mesh.device_list()
        sizes: dict = {}
        for path, shards in _leaves(self.owner.layers[self.i]):
            sh = self.owner.shardings[self.i][path]
            t = _at(new, path)
            if shards[0].dim() == 0:
                for q in self.members:
                    with ops.at_position(q):
                        shards[q] = t.to(devices[q], copy=True)
                    sizes[q] = sizes.get(q, 0) + ops.nbytes(t)
                continue
            r0 = self.rows.start
            for q, sl, lo, hi in self._parts(
                    sh, shards, filter(sh.holds, range(mesh.size))):
                if not ops.runs(q):
                    continue
                src = t[(slice(lo - r0, hi - r0),) + sl[1:]]
                dst = shards[q][lo - sl[0].start:hi - sl[0].start]
                with ops.at_position(q):
                    if t.device.type == "meta":
                        ops.kernel([src], [dst])
                    else:
                        dst.copy_(src)
                sizes[q] = sizes.get(q, 0) + ops.nbytes(src)
        ops.collective("collective-permute", sorted(sizes.items()))
