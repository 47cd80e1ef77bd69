"""Input shapes for every (arch x shape) cell, the port of
``repro.launch.specs``.

The reference describes a cell's inputs as ``jax.ShapeDtypeStruct``s
(``jax.eval_shape``, nothing allocated).  The port describes them as
tensors on the ``meta`` device, which carry a shape and a dtype and hold
no memory: the parameters are a ``Model`` built there, the decode caches
``model.init_cache`` there.

The LM shape grid:
    train_4k     seq 4096,    global_batch 256   -> train_step
    prefill_32k  seq 32768,   global_batch 32    -> prefill_step (forward)
    decode_32k   seq 32768,   global_batch 128   -> serve_step (1 new token,
                                                   KV cache holding seq_len)
    long_500k    seq 524288,  global_batch 1     -> serve_step, sub-quadratic
                                                   archs only

Modality frontends are stubs: whisper cells add precomputed frame
embeddings (B, ``ENC_FRAMES``, d_model); qwen2-vl cells use token inputs
with M-RoPE positions generated internally.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import model
from ..models.config import ModelConfig
from ..optim import adamw

ENC_FRAMES = 1500          # whisper's stub frontend length
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, the reason when it is skipped)."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: O(S^2) attention at 524288 "
                       "is out of scope per task rules (sub-quadratic only)")
    return True, ""


def input_specs(cfg: ModelConfig, shape) -> dict:
    """The cell's step inputs as ``meta`` tensors: "tokens" (and "labels"
    for training, "enc_frames" for an encoder-decoder), or a decode
    step's "token" and "caches".  ``shape`` is a name of ``SHAPES`` or a
    ``ShapeCell``."""
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    out: dict = {}
    if cell.kind in ("train", "prefill"):
        out["tokens"] = torch.empty((b, s), dtype=torch.int32, device=META)
        if cell.kind == "train":
            out["labels"] = torch.empty((b, s), dtype=torch.int32,
                                        device=META)
        if cfg.enc_dec:
            out["enc_frames"] = torch.empty((b, ENC_FRAMES, cfg.d_model),
                                            dtype=torch.bfloat16,
                                            device=META)
    else:                                   # decode: 1 new token + caches
        out["token"] = torch.empty((b, 1), dtype=torch.int32, device=META)
        out["caches"] = model.init_cache(
            cfg, b, s, META, enc_len=ENC_FRAMES if cfg.enc_dec else 0)
    return out


def abstract_params(cfg: ModelConfig) -> model.Model:
    """The model on the ``meta`` device."""
    return model.Model(cfg, None, META)


def abstract_opt_state(params: model.Model) -> adamw.AdamWState:
    """AdamW's state for ``params`` (on ``meta`` for meta parameters)."""
    return adamw.adamw_init(params)
