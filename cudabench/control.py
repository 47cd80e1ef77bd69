"""The control of ``correct``: the plain reference, computed with its
weights in bfloat16 (the precision below the configuration's float32), put
in the program's place; a sound comparison reads it as not correct.

    python3 -m cudabench.control --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

runs the cell's set-up (without the service's warm-up traffic), a short
window at the cell's own load and the comparison, with ``repro_torch.core.aco.colony_step_batch`` (the one step
every path of both configurations runs) replaced by the reference's
bfloat16 iteration, and prints each seed's numbers beside their limits.
CUDA graphs are off in it (the stand-in reads the card while it steps).
The benchmark's own runs never run it; ``tests/test_cudabench_control.py``
runs it at a small size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from cudabench import run
from cudabench.reference import aco as ref

CONTROL_DRAIN_S = 600.0


def reference_step(weight_dtype=torch.bfloat16):
    """A stand-in for ``colony_step_batch`` that steps a stack with the
    reference in ``weight_dtype``."""
    from repro_torch.core import aco

    def step(problem, states, cfg, active=None, n_actual=None,
             iterations=None):
        del active, n_actual, iterations
        nb, n = states.key.shape[0], problem.dist.shape[-1]
        na = problem.n_actual or (n,) * nb
        col = ref.Colony(problem.dist, problem.eta * problem.eta,
                         torch.tensor(na, device=states.key.device),
                         cfg.num_ants(n))
        st = ref.State(states.tau, states.best_tour.long(), states.best_len,
                       states.key)
        if cfg.local_search == "2opt":
            col = col._replace(nn=problem.nn.long())
        new, it_best, _ = ref.iterate(
            col, st, cfg.q, cfg.rho, weight_dtype,
            ls_rounds=cfg.ls_rounds if cfg.local_search == "2opt" else 0)
        return aco.ColonyState(new.tau, new.best_tour.to(torch.int32),
                               new.best_len, states.iteration + 1,
                               new.key), it_best
    return step


@contextlib.contextmanager
def program_replaced(step):
    """Run with ``colony_step_batch`` replaced by ``step`` and the engine's
    CUDA graphs off."""
    from repro_torch.core import aco
    from repro_torch.solver import engine
    saved = aco.colony_step_batch, engine.graph_route
    aco.colony_step_batch = step
    engine.graph_route = lambda *a, **k: False
    try:
        yield
    finally:
        aco.colony_step_batch, engine.graph_route = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    from cudabench import cells
    cell = cells.load(run.ROOT, args.workload)
    if "warmup_s" in cell.traffic:
        # warming serves the timing only; the stand-in steps the whole
        # stack at a few seconds an iteration, so it is given the time to
        # finish every request of the window
        cell.traffic = dict(cell.traffic, warmup_s=0.0,
                            drain_s=CONTROL_DRAIN_S)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with program_replaced(reference_step()):
            res = run.measure(cell, seed, args.seconds, False, "cuda", t0)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"],
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
