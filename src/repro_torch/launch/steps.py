"""Train, prefill and serve step factories shared by the trainer and the
server, the port of ``repro.launch.steps``."""
from __future__ import annotations

from typing import Optional

import torch

from ..analysis import ops
from ..models import model, sharding
from ..models.config import ModelConfig
from ..models.sharded import LayerCache, ShardedCache, ShardedModel
from ..optim import adamw, compression


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: bool = True, compress: bool = False,
                    mesh=None, pspecs: Optional[dict] = None,
                    dspec: Optional[tuple] = None):
    """(params, opt_state, tokens, labels[, enc_frames]) -> (params,
    opt_state, metrics): the loss and its gradients, then one AdamW step
    (``adamw.adamw_update``, which writes the parameters and moments in
    place).  The metrics are the loss's ({"ce", "aux"[, "mtp"], "loss"})
    and the optimizer's ({"grad_norm", "lr"}), 0-d float32 tensors.

    compress=True sends the gradients through the int8 quantise /
    dequantise pair (``optim.compression``) before the optimizer: under
    data parallelism the int8 payload is what would cross the data
    axis.  One scale covers a reference leaf, all periods of a stacked
    one, as in the reference.

    With a ``mesh`` of more than one position the step is the sharded
    one (``_sharded_train_step``): ``params`` is a ``ShardedModel`` over
    that mesh (its specs are ``pspecs``, ``param_specs`` by default), the
    moments ``adamw.adamw_init_sharded``'s, and the batch is split by
    ``dspec`` (``data_specs`` of its size by default)."""
    if mesh is not None and mesh.size > 1:
        return _sharded_train_step(cfg, opt_cfg, remat, compress, mesh,
                                   pspecs, dspec)

    def train_step(params: model.Model, opt_state: adamw.AdamWState,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   enc_frames: Optional[torch.Tensor] = None):
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss_fn(params, tokens, labels, cfg,
                                      enc_frames=enc_frames, remat=remat)
        loss.backward()
        grads = {name: p.grad for name, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        if compress:
            grads = _compress_roundtrip(grads, params)
        params, opt_state, om = adamw.adamw_update(opt_cfg, grads,
                                                   opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om}

    return train_step


def _compress_roundtrip(grads: dict, params: model.Model) -> dict:
    """``grads`` quantised to int8 and back, one scale for each of the
    reference's leaves (``adamw.reference_leaves``)."""
    groups = adamw.reference_leaves(params)
    leaves = [torch.stack([grads[n] for n in names])
              for _, _, names in groups]
    q, scales, _ = compression.compress_grads(leaves, None)
    out = {}
    for (_, _, names), leaf in zip(groups,
                                compression.decompress_grads(q, scales)):
        out.update(zip(names, leaf.unbind(0)))
    return out


def _compress_roundtrip_sharded(grads: dict, params: ShardedModel) -> dict:
    """``_compress_roundtrip`` of gradients held in shards: a reference
    leaf's scale is from the largest magnitude over every shard of its
    parameters (a ``pmax``), then each shard is quantised with it."""
    root = params.root
    out = {}
    for _, _, names in adamw.reference_leaves(params.meta):
        amax = None
        for name in names:
            for pos in params.shardings[name].distinct():
                if grads[name][pos] is None:
                    continue
                m = grads[name][pos].abs().max().to(torch.float32).to(root)
                amax = m if amax is None else torch.maximum(amax, m)
        for name in names:
            out[name] = []
            for g in grads[name]:
                if g is None:
                    out[name].append(None)
                    continue
                q, scale = compression.quantize_int8(
                    g.to(torch.float32), amax=amax.to(g.device))
                out[name].append(compression.dequantize_int8(q, scale))
    return out


def _data_groups(batch: sharding.Sharding) -> list[int]:
    """The data-parallel groups of the batch's sharding, in the order of
    their batch shards: each group's first position (the positions of a
    group hold the same batch shard)."""
    return sorted(batch.distinct(), key=batch.chunk)


def _members(batch: sharding.Sharding, pos: int) -> list[int]:
    """The positions of ``pos``'s data-parallel group."""
    return [q for q in range(batch.mesh.size)
            if batch.chunk(q) == batch.chunk(pos)]


def _check_params(params: ShardedModel, mesh, pspecs: Optional[dict]):
    if params.mesh is not mesh:
        raise ValueError("the parameters are sharded over another mesh")
    if pspecs is not None and params.specs != pspecs:
        raise ValueError("the parameters' specs are not the step's")


def _detached(parts: dict) -> dict:
    """``loss_parts`` with each differentiable sum a new leaf."""
    def leaf(t):
        return t.detach().requires_grad_(True) if t.requires_grad else t
    out = dict(parts)
    for key in ("ce", "mtp"):
        if key in parts:
            out[key] = (leaf(parts[key][0]), parts[key][1])
    out["moe"] = [leaf(t) for t in parts["moe"]]
    return out


def _roots(parts: dict) -> list:
    return ([parts[k][0] for k in ("ce", "mtp") if k in parts]
            + list(parts["moe"]))


def _sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                        remat: bool, compress: bool, mesh,
                        pspecs: Optional[dict], dspec: Optional[tuple]):
    """The train step over a mesh (ZeRO-3 style, ``models/sharded.py``):

    - the batch is split by ``dspec``, and each data-parallel group (the
      positions holding one batch shard) computes its shard once, on its
      first position's device, each layer's weights gathered from their
      shards just before the layer runs;
    - the loss's sums (``model.loss_parts``) are added over the groups
      and divided once (``model.loss_from_parts``): the cross-entropy,
      MTP and MoE aux means are the whole batch's;
    - each group's backward runs after the one before it, so every
      position's gradient is the sum over the data axes in position
      order, of its slice;
    - the global norm counts a replicated slice once, and AdamW updates
      every position's shard (``adamw.adamw_update_sharded``).
    """

    def train_step(params: ShardedModel, opt_state: adamw.AdamWState,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   enc_frames: Optional[torch.Tensor] = None):
        _check_params(params, mesh, pspecs)
        spec = dspec or sharding.data_specs(cfg, mesh, tokens.shape[0])
        batch = sharding.Sharding(mesh, spec)
        groups = _data_groups(batch)
        devices = mesh.device_list()
        leaves = [s for shards in params.shards.values() for s in shards]
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        attached, detached = [], []
        with sharding.activation_sharding(mesh, sharding.axes_of(spec[0]),
                                          shards=len(groups)):
            for pos in filter(ops.runs, groups):
                dev = devices[pos]
                rows = batch.slices(pos, tokens.shape)[0]
                with ops.at_position(pos), params.view(dev) as view:
                    frames = (None if enc_frames is None
                              else enc_frames[rows].to(dev))
                    parts = model.loss_parts(
                        view, tokens[rows].to(dev), labels[rows].to(dev),
                        cfg, enc_frames=frames, remat=remat)
                attached.append((pos, parts))
                detached.append(_detached(parts))
        loss, metrics = model.loss_from_parts(detached, cfg)
        seeds = [r for d in detached for r in _roots(d) if r.requires_grad]
        grads = iter(torch.autograd.grad(loss, seeds, allow_unused=True))
        for (pos, a), d in zip(attached, detached):
            roots, seed = [], []
            for r, dr in zip(_roots(a), _roots(d)):
                if dr.requires_grad:
                    g = next(grads)
                    roots.append(r)
                    seed.append(torch.zeros_like(r) if g is None else g)
            with ops.at_position(pos):
                torch.autograd.backward(roots, seed)
        del attached, detached, seeds
        grads = {name: [s.grad for s in shards]
                 for name, shards in params.shards.items()}
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        if compress:
            grads = _compress_roundtrip_sharded(grads, params)
        params, opt_state, om = adamw.adamw_update_sharded(
            opt_cfg, grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      pspecs: Optional[dict] = None,
                      dspec: Optional[tuple] = None):
    """Full-sequence forward: (params, tokens[, enc_frames]) -> logits
    (B, S, V).

    With a ``mesh`` of more than one position ``params`` is a
    ``ShardedModel`` over it, and each data-parallel group of ``dspec``
    (``data_specs`` of the batch by default) runs its batch shard on its
    first position's device under ``no_grad``, each layer gathered from
    its shards (the sharded train step's design).  The logits are then a
    list with one tensor per position: its group's rows, on its device
    (``Sharding(mesh, dspec + (None,)).gather`` puts them together)."""
    if mesh is not None and mesh.size > 1:
        return _sharded_prefill_step(cfg, mesh, pspecs, dspec)

    def prefill_step(params: model.Model, tokens: torch.Tensor,
                     enc_frames: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        logits, _ = model.forward(params, tokens, cfg, enc_frames=enc_frames)
        return logits

    return prefill_step


def _groups_of(cfg: ModelConfig, mesh, dspec: Optional[tuple],
               batch_size: int) -> tuple[sharding.Sharding, list]:
    spec = dspec or sharding.data_specs(cfg, mesh, batch_size)
    batch = sharding.Sharding(mesh, spec)
    return batch, _data_groups(batch)


def _sharded_prefill_step(cfg: ModelConfig, mesh, pspecs: Optional[dict],
                          dspec: Optional[tuple]):
    devices = mesh.device_list()

    @torch.no_grad()
    def prefill_step(params: ShardedModel, tokens: torch.Tensor,
                     enc_frames: Optional[torch.Tensor] = None) -> list:
        _check_params(params, mesh, pspecs)
        batch, groups = _groups_of(cfg, mesh, dspec, tokens.shape[0])
        out: list = [None] * mesh.size
        with sharding.activation_sharding(
                mesh, sharding.axes_of(batch.spec[0]), shards=len(groups)):
            for pos in filter(ops.runs, groups):
                dev = devices[pos]
                rows = batch.slices(pos, tokens.shape)[0]
                with ops.at_position(pos), params.view(dev) as view:
                    frames = (None if enc_frames is None
                              else enc_frames[rows].to(dev))
                    logits, _ = model.forward(view, tokens[rows].to(dev),
                                              cfg, enc_frames=frames)
                for q in _members(batch, pos):
                    out[q] = logits.to(devices[q])
        return out

    return prefill_step


def make_serve_step(cfg: ModelConfig, sample: str = "greedy", mesh=None,
                    pspecs: Optional[dict] = None,
                    dspec: Optional[tuple] = None,
                    cspecs: Optional[dict] = None):
    """One decode step with a KV cache: (params, token, caches) ->
    (next token (B, 1) int32, caches).

    With a ``mesh`` of more than one position ``params`` is a
    ``ShardedModel`` and ``caches`` a ``ShardedCache`` (built with
    ``cspecs``, ``cache_specs`` of the cache: ``shard_seq`` puts a batch
    of 1's sequence over ``data``): each data-parallel group of ``dspec``
    runs its rows on its first position's device under ``no_grad``, each
    layer gathering its weights and its group's rows of its cache,
    updating them and writing its positions' slices back in place; the
    next tokens come back whole on the first position's device."""
    if sample != "greedy":
        raise ValueError(sample)
    if mesh is not None and mesh.size > 1:
        decode = _sharded_decode_step(cfg, mesh, pspecs, dspec, cspecs)

        def sharded_serve_step(params: ShardedModel, token: torch.Tensor,
                               caches: ShardedCache
                               ) -> tuple[torch.Tensor, ShardedCache]:
            logits, caches = decode(params, token, caches)
            return _greedy(logits), caches

        return sharded_serve_step

    def serve_step(params: model.Model, token: torch.Tensor, caches: dict
                   ) -> tuple[torch.Tensor, dict]:
        logits, caches = model.decode_step(params, token, caches, cfg)
        return _greedy(logits), caches

    return serve_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # argmax takes the first of equal maxima, as jnp.argmax does
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def _sharded_decode_step(cfg: ModelConfig, mesh, pspecs: Optional[dict],
                         dspec: Optional[tuple], cspecs: Optional[dict]):
    """(params, token, caches) -> (logits (B, 1, V) whole on the first
    position's device, caches updated in place): the sharded serve
    step before its argmax."""
    devices = mesh.device_list()

    @torch.no_grad()
    def decode(params: ShardedModel, token: torch.Tensor,
               caches: ShardedCache) -> tuple[torch.Tensor, ShardedCache]:
        _check_params(params, mesh, pspecs)
        if caches.mesh is not mesh:
            raise ValueError("the caches are sharded over another mesh")
        if cspecs is not None and caches.specs != cspecs:
            raise ValueError("the caches' specs are not the step's")
        batch, groups = _groups_of(cfg, mesh, dspec, token.shape[0])
        n_layers = len(caches.layers)
        pieces = []
        with sharding.activation_sharding(
                mesh, sharding.axes_of(batch.spec[0]), shards=len(groups)):
            for pos in filter(ops.runs, groups):
                dev = devices[pos]
                rows = batch.slices(pos, token.shape)[0]
                members = _members(batch, pos)
                group = {"layers": [LayerCache(caches, i, rows, members)
                                    for i in range(n_layers)],
                         "step": caches.step.to(dev)}
                with ops.at_position(pos), params.view(dev) as view:
                    logits, _ = model.decode_step(
                        view, token[rows].to(dev), group, cfg)
                pieces.append(logits.to(devices[0]))
        caches.step = caches.step + 1
        return torch.cat(pieces), caches

    return decode
