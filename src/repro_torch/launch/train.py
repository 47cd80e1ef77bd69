"""End-to-end LM trainer, the port of ``repro.launch.train``: config ->
mesh -> train loop with checkpoint/restart, the resumable synthetic data
pipeline and optional gradient compression.

It runs on the GPU unless ``--device cpu`` is given; without a GPU and
without that flag it raises.  stdout is the ``[train]`` log lines, then
the reference's JSON line ``{"final_loss": ...}``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 10 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --full --steps 8 --batch 8 --seq 128

``--full`` trains the published configuration (OLMo-1B: 2.35 GB of bf16
weights, 9.4 GB of float32 moments).  Weights are random, from a
``torch.Generator`` seeded with ``seed``; the batches are the
reference's own (``data.SyntheticLMData``, bitwise).  An encoder-decoder
(whisper) is fed the audio frontend's stub frames, (B, 64, d_model) of
``sampling.normal`` from key ``seed + 1`` folded with the step.  A
restart resumes from the newest checkpoint in ``ckpt_dir``: parameters,
optimizer state and the data cursor.

Over a mesh of several positions (``devices``, ``--devices N``) the
parameters and moments are held only as their shards
(``models.sharded.ShardedModel``, the specs of ``strategy``) and each
step is the sharded one (``steps.make_train_step(mesh=...)``).  A
position may repeat a device: ``--devices 4 --device cpu`` is a (2, 2)
mesh of CPU positions with ``--model-parallel 2``.  Checkpoints hold
whole tensors in a one-position run's layout, so a run resumes on
another mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --devices 4 --device cpu --model-parallel 2
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import checkpoint as ck
from .. import configs
from .. import device as _device
from ..core import sampling
from ..data import DataConfig, SyntheticLMData
from ..models import model
from ..models.sharded import ShardedModel
from ..optim import adamw
from . import steps as st
from . import tuning
from .mesh import make_mesh_for, resolve_devices
from .serve import ENC_FRAMES


class _StepClock:
    """Each step's wall time: CUDA events recorded after each step on the
    card (read once, at the end: no sync between steps), the host clock on
    the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _state(params, opt_state: adamw.AdamWState, data: SyntheticLMData,
           dev: torch.device) -> dict:
    """The checkpointed tree: parameters by name, optimizer state, data
    cursor (as 0-d int64 tensors).  Sharded parameters and moments are
    gathered whole onto the CPU: a checkpoint has one layout whatever the
    mesh."""
    cursor = {k: torch.tensor(v, device=dev) for k, v in data.state().items()}
    if not isinstance(params, ShardedModel):
        return {"params": dict(params.named_parameters()), "opt": opt_state,
                "data": cursor}
    return {"params": params.whole(params.shards, "cpu"),
            "opt": adamw.AdamWState(params.whole(opt_state.mu, "cpu"),
                                    params.whole(opt_state.nu, "cpu"),
                                    opt_state.step),
            "data": cursor}


def _restore_sharded(mgr: ck.CheckpointManager, params: ShardedModel,
                     opt_state: adamw.AdamWState, data: SyntheticLMData,
                     dev: torch.device):
    """The newest checkpoint's tensors cut into ``params``' shards."""
    def empty(dtype=None) -> dict:
        return {name: torch.empty(p.shape, dtype=dtype or p.dtype)
                for name, p in params.meta.named_parameters()}

    template = {"params": empty(), "opt": adamw.AdamWState(
        empty(torch.float32), empty(torch.float32), opt_state.step.cpu()),
        "data": {k: torch.tensor(v) for k, v in data.state().items()}}
    shardings = {"params": params.shardings,
                 "opt": adamw.AdamWState(params.shardings, params.shardings,
                                         dev),
                 "data": {k: dev for k in template["data"]}}
    return mgr.restore(template, shardings=shardings)


def _positions(device, devices) -> list:
    """The mesh's positions: ``device`` alone; ``devices`` positions of
    ``device`` when both are given and ``devices`` is a count; else
    ``launch.mesh.resolve_devices(devices)``."""
    if devices is None:
        return [_device.resolve(device)]
    if device is not None and isinstance(devices, int):
        return [torch.device(device)] * devices
    return resolve_devices(devices)


def train(arch: str, steps: int, batch: int, seq: int, reduced: bool = True,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          model_parallel: int = 1, compress: bool = False,
          seed: int = 0, log_every: int = 10, lr: float = 3e-4,
          device: _device.DeviceLike = None, devices=None,
          strategy: str = "2d") -> dict:
    """Train ``steps`` steps (from the newest checkpoint in ``ckpt_dir``,
    if any) -> {"final_loss": the last logged loss or None, "losses": the
    logged losses, "step_ms": each step's wall time in this call}.
    ``devices`` (a count or a device list, repeats allowed) and
    ``model_parallel`` shape the mesh; ``strategy`` is "2d" or "fsdp"
    (``tuning.mesh_specs``)."""
    positions = _positions(device, devices)
    dev = positions[0]
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    mesh = make_mesh_for(positions, model_parallel=model_parallel)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                                warmup_steps=max(steps // 20, 1))

    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    pspecs = dspec = None
    if mesh.size > 1:
        pspecs, dspec = tuning.mesh_specs(params, cfg, mesh, batch, strategy)
        params = ShardedModel.from_model(params, mesh, pspecs)
        opt_state = adamw.adamw_init_sharded(params)
    else:
        opt_state = adamw.adamw_init(params)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=seed)
    data = SyntheticLMData(dcfg)
    start_step = 0

    mgr = None
    if ckpt_dir:
        mgr = ck.CheckpointManager(ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            if mesh.size > 1:
                restored, start_step = _restore_sharded(mgr, params,
                                                        opt_state, data, dev)
                params.shards = restored["params"]
            else:
                restored, start_step = mgr.restore(
                    _state(params, opt_state, data, dev))
                with torch.no_grad():
                    for name, p in params.named_parameters():
                        p.copy_(restored["params"][name])
            opt_state = restored["opt"]
            data = SyntheticLMData.restore(dcfg, {
                k: int(v) for k, v in restored["data"].items()})
            print(f"[train] resumed from step {start_step}", flush=True)

    # the one-position step reads the batch on the device; the sharded
    # step cuts it by ``dspec`` itself
    ddev = dev if mesh.size == 1 else "cpu"
    step_fn = st.make_train_step(cfg, opt_cfg, remat=True, compress=compress,
                                 mesh=mesh, pspecs=pspecs, dspec=dspec)
    frames_key = sampling.prng_key(seed + 1)

    losses = []
    t0 = time.time()
    clock = _StepClock(dev)
    for i in range(start_step, steps):
        tokens, labels = next(data)
        frames = None
        if cfg.enc_dec:
            frames = sampling.normal(sampling.fold_in(frames_key, i), (
                batch, ENC_FRAMES, cfg.d_model)).to(ddev)
        params, opt_state, metrics = step_fn(
            params, opt_state, torch.from_numpy(tokens).to(ddev),
            torch.from_numpy(labels).to(ddev), frames)
        clock.mark()
        if (i + 1) % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i+1-start_step):.2f}s/step)",
                  flush=True)
        if mgr and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, _state(params, opt_state, data, dev))
    if mgr:
        mgr.save(steps, _state(params, opt_state, data, dev))
        mgr.wait()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "step_ms": clock.step_ms()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published configuration, not the reduced one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--strategy", default="2d", choices=tuning.STRATEGIES)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "there)")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh positions: that many cards, or that many "
                         "positions of --device")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, args.batch, args.seq, args.reduced,
                args.ckpt_dir, args.ckpt_every, args.model_parallel,
                args.compress, args.seed, device=args.device,
                devices=args.devices, strategy=args.strategy)
    print(json.dumps({"final_loss": out["final_loss"]}))


if __name__ == "__main__":
    main()
