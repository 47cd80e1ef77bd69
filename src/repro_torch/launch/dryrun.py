"""Multi-pod dry run, the port of ``repro.launch.dryrun``: trace every
(arch x shape x mesh) cell's step and record its memory, cost,
collectives and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--tuned] [--force]

The reference forces 512 host devices and lowers and compiles each cell
for its production meshes.  The port's positions are ``meta`` devices
(``launch.mesh.make_production_mesh``): a ``meta`` tensor carries a shape
and a dtype and holds no memory, so the step's operations are dispatched
and counted (``analysis.ops.accumulate``) while nothing is computed or
allocated.  This is not a CPU fallback: no value is produced anywhere.

Per cell it writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>
.json`` (``_tuned`` with ``--tuned``) with the reference's keys:
``status``, ``devices``, ``tuning``, ``memory_analysis`` (argument,
output and temp bytes of the largest position), ``cost_analysis``
(``flops``: dot FLOPs, ``bytes accessed``: the unfused operand + result
bytes), ``collectives`` (bytes by kind, ``total``, ``count``),
``roofline``, ``params_total``, ``params_active``; ``trace_s`` takes the
place of ``lower_s`` and ``compile_s``.

What differs from the reference's numbers, and why:

- every data-parallel group does the same work, so a sharded step is
  traced for the first group's positions and each other position is
  given its counterpart's counts (``accumulate(..., data_spec=...)``);
- the port gathers a layer's weights and runs the layer whole on its
  group's first position (``models/sharded.py``): that position's dot
  FLOPs are about |model| times the reference's per-device FLOPs, which
  ``useful_flops_ratio`` shows;
- ``collective_s`` divides every collective's bytes by the NVLink rate
  (``HW["nvlink_bw"]``), the ``pod`` axis's too (``collective_rate``
  in the record says so).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from .. import configs
from ..analysis import ops
from ..models import sharding as sh
from ..models.sharded import ShardedCache, ShardedModel
from ..optim import adamw
from . import specs as sp
from . import steps as st
from . import tuning
from .mesh import HW, make_production_mesh

OUT = "experiments/dryrun_torch"
PER_POSITION = ("argument_size_in_bytes", "temp_size_in_bytes",
                "collective_bytes/all-gather",
                "collective_bytes/reduce-scatter")
COLLECTIVE_RATE = ("every collective's bytes over HW['nvlink_bw'], the "
                   "pod axis's included")


def model_flops(cfg, cell: sp.ShapeCell) -> float:
    """6·N·D with N = active params (MoE) and D = processed tokens."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch          # decode: 1 token/seq


def _step_and_args(cfg, cell: sp.ShapeCell, mesh, strategy: str) -> tuple:
    """The cell's step over ``mesh`` and its ``meta`` arguments ->
    (step, args, the batch spec or None on one position)."""
    params = sp.abstract_params(cfg)
    ins = sp.input_specs(cfg, cell)
    frames = ins.get("enc_frames")
    sharded = mesh is not None and mesh.size > 1
    pspecs = dspec = None
    if sharded:
        pspecs, dspec = tuning.mesh_specs(params, cfg, mesh,
                                          cell.global_batch, strategy)
        params = ShardedModel.from_model(params, mesh, pspecs)
    kw = dict(mesh=mesh, pspecs=pspecs, dspec=dspec) if sharded else {}
    if cell.kind == "train":
        opt = (adamw.adamw_init_sharded(params) if sharded
               else sp.abstract_opt_state(params))
        step = st.make_train_step(cfg, adamw.AdamWConfig(), remat=True, **kw)
        args = [params, opt, ins["tokens"], ins["labels"]]
        if cfg.enc_dec:
            args.append(frames)
    elif cell.kind == "prefill":
        step = st.make_prefill_step(cfg, **kw)
        args = [params, ins["tokens"]] + ([frames] if cfg.enc_dec else [])
    else:
        caches = ins["caches"]
        if sharded:
            cspecs = sh.cache_specs(caches, cfg, mesh, cell.global_batch,
                                    shard_seq=(cell.global_batch == 1))
            caches = ShardedCache.from_cache(caches, mesh, cspecs)
            kw["cspecs"] = cspecs
        step = st.make_serve_step(cfg, **kw)
        args = [params, ins["token"], caches]
    return step, args, dspec


def trace_cell(cfg, cell: sp.ShapeCell, mesh=None,
               strategy: str = "2d") -> dict:
    """Trace ``cell``'s step of ``cfg`` on ``mesh`` (``meta`` positions;
    one position without a mesh), the counterpart of ``lower_cell`` ->
    the record's measured part: ``devices``, ``trace_s``,
    ``memory_analysis``, ``cost_analysis``, ``collectives``,
    ``roofline``, ``params_total``, ``params_active``, and
    ``per_position`` (each position's ``PER_POSITION`` figures)."""
    t0 = time.time()
    step, args, dspec = _step_and_args(cfg, cell, mesh, strategy)
    acc = ops.accumulate(step, *args, mesh=mesh, data_spec=dspec)
    trace_s = time.time() - t0
    n_dev = 1 if mesh is None else mesh.size
    coll = dict(acc["collective_bytes"])
    coll["total"] = acc["collective_total"]
    coll["count"] = acc["collective_count"]
    flops_dev = acc["dot_flops"]
    bytes_dev = acc["bytes_accessed"]
    mf = model_flops(cfg, cell)
    terms = {
        "compute_s": flops_dev / HW["peak_flops_bf16"],
        "memory_s": bytes_dev / HW["hbm_bw"],
        "collective_s": coll["total"] / HW["nvlink_bw"],
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops_dev if flops_dev else None,
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return {
        "status": "ok", "devices": n_dev, "trace_s": round(trace_s, 2),
        "memory_analysis": acc["memory"],
        "cost_analysis": {"flops": flops_dev, "bytes accessed": bytes_dev},
        "collectives": coll, "collective_rate": COLLECTIVE_RATE,
        "roofline": terms,
        "per_position": {k: [int(round(v)) for v in acc["positions"][k]]
                         for k in PER_POSITION},
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def _cell_config(arch: str, shape: str, tuned: bool) -> tuple:
    """(cfg, the tuning applied or None, the mesh strategy)."""
    cfg = configs.get(arch)
    applied, strategy = None, "2d"
    if tuned:
        applied = tuning.overrides_for(arch, shape)
        if applied:
            applied = dict(applied)
            strategy = applied.pop("mesh_strategy", "2d")
            if applied:
                cfg = dataclasses.replace(cfg, **applied)
            applied["mesh_strategy"] = strategy
    return cfg, applied, strategy


def lower_cell(arch: str, shape: str, multi_pod: bool,
               tuned: bool = False) -> dict:
    """One production cell's record (``trace_cell`` on the 16 x 16 or 2 x
    16 x 16 ``meta`` mesh), or its skip."""
    cfg, applied, strategy = _cell_config(arch, shape, tuned)
    head = {"arch": arch, "shape": shape,
            "mesh": "multi" if multi_pod else "single"}
    ok, why = sp.cell_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    rec = trace_cell(cfg, sp.SHAPES[shape],
                     make_production_mesh(multi_pod=multi_pod), strategy)
    return {**head, **rec, "tuning": applied}


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: str,
             force: bool = False, tuned: bool = False) -> dict:
    """The cell's record, read from ``outdir`` when it is there (unless
    ``force``), else traced and written there."""
    os.makedirs(outdir, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    suffix = "_tuned" if tuned else ""
    path = os.path.join(outdir, f"{arch}__{shape}__{mesh_tag}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        rec = lower_cell(arch, shape, multi_pod, tuned=tuned)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2)
    os.replace(tmp, path)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="apply launch.tuning overrides and their mesh "
                         "strategy (records end in _tuned)")
    args = ap.parse_args(argv)

    archs = list(configs.ARCHS) if args.arch == "all" else [
        configs.canonical(args.arch)]
    shapes = list(sp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out, args.force,
                               tuned=args.tuned)
                tag = f"{arch} x {shape} x {rec['mesh']}"
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"[OK]   {tag}: trace={rec['trace_s']}s "
                          f"bottleneck={r['bottleneck']} "
                          f"(c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
                          f"n={r['collective_s']:.3e})", flush=True)
                    print("  memory:", rec["memory_analysis"], flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"[SKIP] {tag}: {rec['reason']}", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"done: {n_ok} ok / {n_skip} skipped / {n_fail} failed", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
