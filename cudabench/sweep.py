"""Find the knee of a streaming cell's mix: the highest offered rate at
which the backlog does not grow through the window.

    python3 -m cudabench.sweep --workload <cell> --rates 6,8,10 \\
        --seconds 20 --seed <n>

Each rate runs the cell's set-up and window with the mix's rate replaced,
and prints one JSON line: the completed requests per second, the p95
latency from due time, and the backlog's slope (requests per second, a
least-squares fit over the window's second half).  The knee found is
written into the cells' traffic files by hand.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from cudabench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    from cudabench import cells
    base = cells.load(run.ROOT, args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = dataclasses.replace(base, traffic=dict(base.traffic,
                                                      rate=rate))
        t0 = time.perf_counter()
        s = cell.driver.Session(cell, args.seed, "cuda", args.seconds)
        wall = s.window(args.seconds)
        res = s.results(wall)["metrics"]
        pts = np.array([p for p in s.run.backlog if p[0] >= wall / 2])
        slope = float(np.polyfit(pts[:, 0], pts[:, 1], 1)[0]) \
            if len(pts) > 2 else None
        print(json.dumps({"rate": rate, "offered": len(s.items) / wall,
                          "completed_per_s": res["instances_per_s"],
                          "latency_p95_s": res["latency_p95_s"],
                          "backlog_slope": slope,
                          "backlog_end": s.run.backlog[-1][1]
                          if s.run.backlog else None,
                          "occupancy": s.occupancy,
                          "setup_s": time.perf_counter() - t0 - wall}),
              flush=True)
        s.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
