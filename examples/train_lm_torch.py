"""End-to-end example, the PyTorch port of examples/train_lm.py: train a
~100M-parameter OLMo-family model for a few hundred steps on the
synthetic resumable pipeline, with checkpointing.

Full run (~100M params, float32; on the GPU unless --device says
otherwise):
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300

Quick demo (the reduced OLMo, ~1M params; about 10 s on the CPU):
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu

Over a mesh (parameters and moments held in shards, ``--devices``
positions, ``--model-parallel`` of them along the model axis; with
``--device`` the positions may share it):
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu \
        --devices 4 --model-parallel 2

Checkpoints go to ``--ckpt-dir`` (default: a new temporary directory);
a second run over the same directory resumes from its newest one, on any
mesh.
"""
import argparse
import sys
import tempfile
import types

from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models.config import LayerSpec, ModelConfig

# ~100M-param member of the olmo family (non-parametric LN, swiglu, tied).
OLMO_100M = ModelConfig(
    name="olmo-100m",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_head=64,
    d_ff=3072,
    vocab=50304,
    period=(LayerSpec(),),
    norm="nonparam_ln",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)


def _register_olmo_100m() -> None:
    """Make ``olmo_100m`` an architecture ``configs.get`` knows."""
    mod = types.ModuleType("repro_torch.configs.olmo_100m")
    mod.CONFIG = mod.REDUCED = OLMO_100M
    sys.modules[mod.__name__] = mod
    if "olmo_100m" not in configs.ARCHS:
        configs.ARCHS = tuple(configs.ARCHS) + ("olmo_100m",)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 300, or 60 with --quick")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "there)")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh positions: that many cards, or that many "
                         "positions of --device")
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)
    mesh = dict(devices=args.devices, model_parallel=args.model_parallel)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ck_")

    if args.quick:
        out = train("olmo_1b", steps=args.steps or 60, batch=8, seq=128,
                    reduced=True, ckpt_dir=ckpt_dir, ckpt_every=20,
                    lr=3e-3, log_every=10, device=args.device, **mesh)
    else:
        _register_olmo_100m()
        out = train("olmo_100m", steps=args.steps or 300, batch=8, seq=256,
                    reduced=False, ckpt_dir=ckpt_dir, ckpt_every=50,
                    lr=1e-3, log_every=10, device=args.device, **mesh)
    print("final loss:", out["final_loss"])
    return out


if __name__ == "__main__":
    main()
