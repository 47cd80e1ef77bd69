"""Train, prefill and serve step factories shared by the trainer and the
server, the port of ``repro.launch.steps``."""
from __future__ import annotations

from typing import Optional

import torch

from ..models import model
from ..models.config import ModelConfig
from ..optim import adamw, compression


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: bool = True, compress: bool = False):
    """(params, opt_state, tokens, labels[, enc_frames]) -> (params,
    opt_state, metrics): the loss and its gradients, then one AdamW step
    (``adamw.adamw_update``, which writes the parameters and moments in
    place).  The metrics are the loss's ({"ce", "aux"[, "mtp"], "loss"})
    and the optimizer's ({"grad_norm", "lr"}), 0-d float32 tensors.

    compress=True sends the gradients through the int8 quantise /
    dequantise pair (``optim.compression``) before the optimizer: under
    data parallelism the int8 payload is what would cross the data
    axis.  One scale covers a reference leaf, all periods of a stacked
    one, as in the reference."""

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


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward: (params, tokens[, enc_frames]) -> logits
    (B, S, V)."""

    def prefill_step(params: model.Model, tokens: torch.Tensor,
                     enc_frames: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        logits, _ = model.forward(params, tokens, cfg, enc_frames=enc_frames)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, sample: str = "greedy"):
    """One decode step with a KV cache: (params, token, caches) ->
    (next token (B, 1) int32, caches)."""
    if sample != "greedy":
        raise ValueError(sample)

    def serve_step(params: model.Model, token: torch.Tensor, caches: dict
                   ) -> tuple[torch.Tensor, dict]:
        logits, caches = model.decode_step(params, token, caches, cfg)
        # argmax takes the first of equal maxima, as jnp.argmax does
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], caches

    return serve_step
