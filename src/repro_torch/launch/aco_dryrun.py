"""ACO-at-scale dry run, the port of ``repro.launch.aco_dryrun``: trace
the city-sharded colony step for a large TSP instance on the production
mesh and report the same roofline terms as the LM cells.

    PYTHONPATH=src python -m repro_torch.launch.aco_dryrun --n 16384 \\
        [--variant baseline|ants|ants_bf16|all] [--multi-pod]

Variants (the reference's ladder):
    baseline   city axis sharded over ``model``; ants replicated over
               ``data`` (the paper's data-parallel design, mesh-tiled)
    ants       + ant population sharded over ``data`` (deposit psum)
    ants_bf16  + bf16 choice slabs (halves the construction gather bytes)

The positions are ``meta`` devices (``make_production_mesh``), so the
step's operations are dispatched and counted by ``analysis.ops`` and
nothing is computed or allocated.  The construction's n - 1 steps
dispatch the same operations on the same shapes, so the trace runs the
first ``SAMPLE`` of them and scales their counts to the whole loop
(``accumulate(..., sample=...)``, the port's counterpart of the
reference's while-loop trip count).  The positions that share a device
(all of them, on ``meta``) step as one stack, whose every operation is
split evenly over them.  Writes ``experiments/aco_dryrun_torch/
aco_n<n>__<variant>__<single|multi>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..analysis import ops
from ..core import aco, islands
from .mesh import HW, make_production_mesh

OUT = "experiments/aco_dryrun_torch"
VARIANTS = ("baseline", "ants", "ants_bf16")
SAMPLE = 2          # construction steps traced; the rest scaled from them


def variant_options(variant: str) -> dict:
    """``sharded_colony_step_fn``'s ants axis and choice dtype of a
    variant."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    return {"ants_axis": None if variant == "baseline" else "data",
            "choice_dtype": (torch.bfloat16 if variant.endswith("bf16")
                             else torch.float32)}


def abstract_colony(mesh, n: int) -> tuple:
    """(dist slabs, eta slabs, state) of an n-city colony over ``mesh``'s
    positions, as ``meta`` tensors: each position's own (n, n/S) column
    slabs (S the ``model`` axis), the replicated state on the first
    position."""
    nl = n // mesh.shape["model"]

    def slabs() -> list:
        return [torch.empty((n, nl), dtype=torch.float32, device=d)
                for d in mesh.device_list()]

    home = mesh.device_list()[0]
    st = islands.ShardedColonyState(
        tau=slabs(),
        best_tour=torch.empty((n,), dtype=torch.int32, device=home),
        best_len=torch.empty((), dtype=torch.float32, device=home),
        iteration=torch.empty((), dtype=torch.int32, device=home),
        key=torch.empty((2,), dtype=torch.int64, device=home))
    return slabs(), slabs(), st


def trace_colony(mesh, n: int, cfg: aco.ACOConfig, use_pallas: bool = False,
                 **options) -> dict:
    """``accumulate`` of one city-sharded colony step over ``mesh``
    (``meta`` positions) on an n-city colony; ``options`` are
    ``sharded_colony_step_fn``'s ``ants_axis`` and ``choice_dtype``."""
    step = islands.sharded_colony_step_fn(mesh, n, cfg, "model", use_pallas,
                                          **options)
    dist_l, eta_l, st = abstract_colony(mesh, n)
    return ops.accumulate(step, dist_l, eta_l, st, mesh=mesh, sample=SAMPLE)


def trace_aco(n: int, variant: str, multi_pod: bool) -> dict:
    """The counterpart of ``lower_aco``: the record of one variant."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    acc = trace_colony(mesh, n, aco.ACOConfig(), **variant_options(variant))
    trace_s = time.time() - t0
    terms = {
        "compute_s": acc["dot_flops"] / HW["peak_flops_bf16"],
        "memory_s": acc["bytes_accessed"] / HW["hbm_bw"],
        "collective_s": acc["collective_total"] / HW["nvlink_bw"],
    }
    terms["bottleneck"] = max(terms, key=terms.get)
    return {
        "workload": f"aco_sharded_colony_n{n}", "variant": variant,
        "mesh": "multi" if multi_pod else "single", "devices": mesh.size,
        "status": "ok", "trace_s": round(trace_s, 2), "sampled_steps": SAMPLE,
        "roofline": terms, "collectives": acc["collective_bytes"],
        "collective_count": acc["collective_count"],
        "memory_analysis": acc["memory"],
        "cost_analysis": {"flops": acc["dot_flops"],
                          "bytes accessed": acc["bytes_accessed"]},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--variant", default="all",
                    choices=list(VARIANTS) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    variants = list(VARIANTS) if args.variant == "all" else [args.variant]
    os.makedirs(args.out, exist_ok=True)
    for v in variants:
        rec = trace_aco(args.n, v, args.multi_pod)
        path = os.path.join(
            args.out, f"aco_n{args.n}__{v}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        t = rec["roofline"]
        print(f"[OK] {v:10s} trace={rec['trace_s']}s "
              f"c={t['compute_s']:.3e} m={t['memory_s']:.3e} "
              f"n={t['collective_s']:.3e} -> {t['bottleneck']}", flush=True)


if __name__ == "__main__":
    main()
