"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m cudabench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (``setup_s``: from process start to the window) builds the
kernels on a checkout's first run (in the port's default build root,
``src/repro_torch/kernels/build/``, a fixed directory of the checkout; the
build's seconds are also reported apart, as ``build_s`` in the result
line) and warms the cell's shapes; the window measures for ``--seconds``; then the
program's outputs are compared with the plain reference.  ``--trace 1``
profiles the window and reports the cell's per-layer metrics instead of
its end-to-end ones, with the device's busy time and a breakdown.

The last lines on standard error, and the last key of the result line,
are the numbers compared, each beside its limit.  The run fails without a
result where there is no card, too few cards, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Set up, run the window, read the metrics, compare; the result line
    as a dict (``checks`` last)."""
    import torch

    from cudabench import trace as tr
    from repro_torch.kernels import _build
    session = cell.driver.Session(cell, seed, device, seconds, trace)
    setup_s = time.perf_counter() - t_start
    # the part of set-up spent compiling the kernel library (0 once the
    # checkout holds it), recorded apart from ``setup_s``, which holds it
    build_s = float(_build.LOADED.get("build_s", 0.0))
    cuda = torch.device(device).type == "cuda"
    with tr.profiler(trace) as prof:
        wall = session.window(seconds)
    session.finish()
    out = session.results(wall)
    capture = tr.read(prof) if trace else None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(0)
           if cuda else 0}
    metrics = {}
    if trace:
        dev["busy_s"], dev["window_s"] = capture.busy_s, capture.window_s
        ctx = {"capture": capture, "session": session, "wall": wall}
        for spec, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        print(f"cudabench: read {json.dumps(values)}", file=sys.stderr)
        for spec in cell.end_to_end:
            metrics[spec["name"]] = {"value": values[spec["name"]],
                                     "unit": spec["unit"]}
    session.free()
    t_check = time.perf_counter()
    checks = session.check()
    print(f"cudabench: set-up {setup_s:.3f} s (of it the kernel build "
          f"{build_s:.3f} s), window {wall:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev, "build_s": build_s}
    if trace:
        result["breakdown"] = {"device_ops": capture.device_ops(),
                               "idle_gaps": capture.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from cudabench import cells
    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("cudabench: torch.cuda.is_available() is false; this "
              "benchmark runs on a card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"cudabench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 3
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"cudabench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
