"""Prefill and serve step factories for the server, the serving half of
``repro.launch.steps`` (``make_train_step`` comes with training, ROADMAP
item 18.5)."""
from __future__ import annotations

from typing import Optional

import torch

from ..models import model
from ..models.config import ModelConfig


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
