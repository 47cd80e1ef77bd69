"""Batched serving entry point, the PyTorch port of ``repro.launch.serve``:
prefill a batch of prompts, then greedy-decode.

It runs on the GPU unless ``--device cpu`` is given; without a GPU and
without that flag it raises.  stdout is the reference's JSON report
(``prefill_s``, ``decode_s_per_token``, ``throughput_tok_s``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_2b \\
        --batch 4 --prompt-len 16 --gen 16 --device cpu

``--full`` serves the published configuration instead of the reduced one
(OLMo-1B at full width and depth takes 2.35 GB of bf16 weights on the
card).  Every architecture serves: attention decoders, MoE, MLA, Mamba
and the Jamba hybrid, and whisper's encoder-decoder.  Weights are
random, from ``torch.Generator`` seeded with ``seed``; the prompts are
the reference's own, drawn by the port's threefry ``randint`` from key
``seed + 1``, and an encoder-decoder's frames (B, 64, d_model), the
audio frontend's stub, are the reference's ``normal`` draw from that
key folded with 1 (``sampling.normal``, ulp-close).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from .. import device as _device
from ..core import sampling
from ..models import model
from ..models.config import ModelConfig
from . import steps as st


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ENC_FRAMES = 64      # the encoder's frames a request (the reference's)


def load(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
         dev: torch.device
         ) -> tuple[model.Model, torch.Tensor, Optional[torch.Tensor]]:
    """Random weights (``torch.Generator`` seeded with ``seed``), the
    reference's prompts (B, S) int32 and, for an encoder-decoder, its
    encoder frames (B, ``ENC_FRAMES``, d_model) float32 (else None), all
    on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(cfg, gen, dev)
    key = sampling.prng_key(seed + 1)
    prompts = sampling.randint(key, (batch, prompt_len), 0, cfg.vocab)
    frames = None
    if cfg.enc_dec:
        frames = sampling.normal(sampling.fold_in(key, 1),
                                 (batch, ENC_FRAMES, cfg.d_model)).to(dev)
    return params, prompts.to(dev), frames


def generate(params: model.Model, prompts: torch.Tensor, cfg: ModelConfig,
             gen: int, enc_frames: Optional[torch.Tensor] = None) -> dict:
    """Prefill ``prompts`` (the step loop; an encoder-decoder encodes
    ``enc_frames`` first), then ``gen - 1`` greedy decode steps; the
    report with the (B, gen) tokens.  Times are host clocks around
    synchronised work."""
    dev = prompts.device
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen + 1
    t0 = time.perf_counter()
    logits, caches, _ = model.prefill(params, prompts, cfg, max_len,
                                      enc_frames=enc_frames)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve_step = st.make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    out_tokens = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, caches = serve_step(params, tok, caches)
        out_tokens.append(tok.cpu().numpy())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen_tokens = np.concatenate(out_tokens, axis=1)
    return {
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1),
        "tokens": gen_tokens.tolist(),
        "throughput_tok_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def serve(arch: str, batch: int, prompt_len: int, gen: int,
          reduced: bool = True, seed: int = 0,
          device: _device.DeviceLike = None) -> dict:
    dev = _device.resolve(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    with torch.inference_mode():
        params, prompts, frames = load(cfg, batch, prompt_len, seed, dev)
        return generate(params, prompts, cfg, gen, frames)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published configuration, not the reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "there)")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.batch, args.prompt_len, args.gen,
                args.reduced, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "tokens"},
                     indent=2))


if __name__ == "__main__":
    main()
