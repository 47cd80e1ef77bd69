"""Batched TSP solver serving CLI, the PyTorch port of
``repro.launch.solve_serve``.

Two modes:

- default: generate a mixed workload, submit everything to the
  drain-the-queue SolverService, run the bucket scheduler, print JSON stats;
- ``--stream``: replay a Poisson arrival trace through the
  continuous-batching StreamingSolverService -- requests are admitted into
  resident slots mid-run as they arrive.

It runs on the GPU unless ``--device cpu`` is given; without a GPU and
without that flag it raises.  stdout carries only the JSON report
(``repro.solve_serve/v1``, the reference's schema); messages go to stderr.

``--sparse`` swaps the dense (n, n) pipeline for the candidate-list
O(n*k) paged representation in the drain-the-queue mode; on the kernel
route (``--use-pallas``) each engine iteration walks the whole bucket in
one ``sparse_walk`` launch.  sparse x streaming / local-search
combinations exit 2 with the route checker's one-line reason.

Telemetry (``repro_torch.obs``): ``--metrics`` turns on the per-step
convergence metrics (bitwise-neutral; each result gains a ``metrics``
row), ``--metrics-out``/``--trace-out``/``--events-out`` export the
registry snapshot, the Perfetto-loadable Chrome trace, and the JSON-lines
slot-lifecycle event log; ``--stats-every`` emits periodic stats_snapshot
events during a ``--stream`` replay and ``--profile-dir`` wraps the run
in a ``torch.profiler`` capture.  ``--metrics-port`` serves ``GET
/metrics`` (Prometheus text), ``/healthz`` and ``/snapshot`` from a
background thread for the whole run; ``--metrics-hold`` keeps it up after
the drain.  ``--tenant a,b`` cycles tenant labels over the workload.

``--tau-dtype bf16|int8`` holds every resident pheromone matrix in low
precision; compute stays fp32 (the kernels dequantise in registers).

``--shard`` places the solver over a 1-D mesh (``launch.mesh``): batch
jobs shard their instance axis across its positions, and streaming mode
runs one resident pool per position.  ``--devices`` sizes the mesh: the
first that many cards (default all local cards; more than there are
fails as the reference's ``data_mesh`` does), or, with ``--device``, that
many positions of the one device given (``--device cpu --shard --devices
4`` runs a 4-position mesh on the CPU; default one position).

Program cache (``solver/programs.py``): ``--warmup`` warms the bucket
ladder for the [min_n, max_n] range before traffic (on the card: one eager
engine iteration and CUDA graphs of one engine iteration per bucket;
``--warmup-async`` on a background thread; ``--bucket-ladder 16,32``
overrides the rungs), ``--cache-dir`` builds and loads the kernel library
in that directory, so a restart loads the build instead of compiling it,
and ``--dry`` warms the ladder, prints the program and cache stats as JSON
and exits.  With ``--draw-mode counter`` and ``--ants`` pinned, admission
may route a request whose bucket is cold into the nearest larger warmed
one, bitwise exactly.

Usage, on the card and on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --use-pallas \\
        --variant mmas --num-instances 6 --min-n 500 --max-n 1002 \\
        --iterations 6 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --sparse \\
        --use-pallas --ants 64 --sparse-k 16 --num-instances 6 \\
        --min-n 1500 --max-n 2392 --iterations 10 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --device cpu \\
        --stream --num-instances 4 --min-n 12 --max-n 28 --iterations 5 \\
        --max-batch 2 --arrival-rate 20 --chunk 2
    PYTHONPATH=src python -m repro_torch.launch.solve_serve --use-pallas \\
        --variant mmas --min-n 500 --max-n 1002 --max-batch 4 --warmup \\
        --cache-dir /tmp/aco-kernels [--dry]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import device as _device
from .. import obs
from ..core import aco, tsp
from ..kernels.ops import UnsupportedKernelRoute
from .mesh import make_data_mesh
from ..kernels import _build
from ..solver import (ProgramCache, SolverService, StreamingSolverService,
                      enable_persistent_cache, make_poisson_trace,
                      persistent_cache_stats, replay_trace)


def make_workload(num: int, min_n: int, max_n: int, seed: int):
    """Alternating random/circle instances with sizes across the range
    (circle instances carry a known optimum, so the service reports gaps)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(num):
        n = int(rng.randint(min_n, max_n + 1))
        if i % 2 == 0:
            out.append(tsp.circle_instance(n, seed=seed + i))
        else:
            out.append(tsp.random_instance(n, seed=seed + i))
    return out


def _round(obj, nd: int = 4):
    """Recursive float rounding: one rule for every level of the report."""
    if isinstance(obj, float):
        return round(obj, nd) if np.isfinite(obj) else obj
    if isinstance(obj, dict):
        return {k: _round(v, nd) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round(v, nd) for v in obj]
    return obj


def _report(results, stats) -> None:
    gaps = [r.gap_pct for r in results if r.gap_pct is not None]
    rows = []
    for r in results:
        row = {"id": r.request_id, "name": r.name, "n": r.n,
               "bucket": r.bucket, "best_len": r.best_len,
               "iterations": r.iterations, "gap_pct": r.gap_pct,
               "latency_s": r.latency_s}
        if r.trace_id:
            row["trace_id"] = r.trace_id
        if r.tenant is not None:
            row["tenant"] = r.tenant
        if r.expired:
            row["expired"] = True
        if r.metrics is not None:
            row["metrics"] = r.metrics
        rows.append(row)
    # flush: under --metrics-hold the process may be killed right after
    # the hold starts, and the redirected report must already be on disk
    print(json.dumps(_round({
        "schema": "repro.solve_serve/v1",
        "results": rows,
        "mean_gap_pct": float(np.mean(gaps)) if gaps else None,
        "stats": stats,
    }), indent=2), flush=True)


def _start_metrics_server(args, tel, svc):
    """Bind the exposition endpoint (obs.MetricsServer) over the run's
    Telemetry with the service's live health view; announces the bound
    port on stderr (stdout stays pure JSON for the report)."""
    if args.metrics_port is None:
        return None
    server = obs.MetricsServer(tel, health_fn=svc.health,
                               snapshot_extra_fn=lambda: {"stats": svc.stats},
                               port=args.metrics_port)
    print(f"solve_serve: metrics endpoint on "
          f"http://127.0.0.1:{server.port} "
          f"(/metrics /healthz /snapshot)", file=sys.stderr)
    return server


def _hold_endpoint(args, server) -> None:
    """--metrics-hold: keep serving after the drain so an external
    scraper can read the final state."""
    if server is not None and args.metrics_hold > 0:
        time.sleep(args.metrics_hold)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "solve_serve")
    ap.add_argument("--num-instances", type=int, default=8)
    ap.add_argument("--min-n", type=int, default=12)
    ap.add_argument("--max-n", type=int, default=48)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--variant", default="as", choices=["as", "mmas", "acs"])
    ap.add_argument("--selection", default="iroulette")
    ap.add_argument("--local-search", default="none")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--min-bucket", type=int, default=16)
    ap.add_argument("--patience", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the current CUDA "
                         "device; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="route construction and deposit through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--tau-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="resident pheromone precision: bf16 halves / int8 "
                         "quarters the per-slot tau bytes (per-row scales, "
                         "stochastic quantise-on-store); compute stays fp32")
    ap.add_argument("--tau-round", default="stochastic",
                    choices=["stochastic", "nearest"],
                    help="--tau-dtype bf16/int8: quantise-on-store rounding")
    ap.add_argument("--sparse", action="store_true",
                    help="candidate-list-restricted O(n*k) representation: "
                         "no resident (n, n) tensor; incompatible with "
                         "--stream and local search")
    ap.add_argument("--sparse-k", type=int, default=32,
                    help="--sparse: candidate-list width per city")
    ap.add_argument("--sparse-overflow", type=int, default=4,
                    help="--sparse: per-city off-list adoption slots "
                         "(0 disables adoption)")
    ap.add_argument("--shard", action="store_true",
                    help="shard the solver over a 1-D device mesh: batch "
                         "jobs split their instance axis across devices; "
                         "--stream runs one resident pool per device")
    ap.add_argument("--devices", type=int, default=None,
                    help="--shard: mesh size (default: all local devices; "
                         "with --device, positions of that one device, "
                         "default 1)")
    ap.add_argument("--stream", action="store_true",
                    help="replay a Poisson arrival trace through the "
                         "continuous-batching streaming service")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="--stream: Poisson arrivals per second")
    ap.add_argument("--chunk", type=int, default=2,
                    help="--stream: iterations per scheduler tick")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="--stream: admission backpressure bound")
    ap.add_argument("--per-instance-hyper", action="store_true",
                    help="--stream: per-slot alpha/beta/rho/q operands so "
                         "one bucket mixes tuning profiles (incompatible "
                         "with --use-pallas)")
    ap.add_argument("--metrics", action="store_true",
                    help="carry per-step convergence metrics next to every "
                         "colony (bitwise-neutral): each result gains a "
                         "metrics row")
    ap.add_argument("--metrics-out", default=None,
                    help="write the repro.obs/v1 registry snapshot JSON "
                         "here at exit")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace (Perfetto-loadable) "
                         "timeline JSON here at exit")
    ap.add_argument("--events-out", default=None,
                    help="mirror the JSON-lines slot-lifecycle event log "
                         "to this file as records arrive")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="--stream: emit a stats_snapshot event every this "
                         "many seconds during the replay")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace (Chrome trace JSON) "
                         "of the whole run into this directory")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text), /healthz "
                         "and /snapshot on this port for the whole run (0 = "
                         "ephemeral; the bound port is printed to stderr)")
    ap.add_argument("--metrics-hold", type=float, default=0.0,
                    help="keep the --metrics-port endpoint up this many "
                         "seconds after the workload drains")
    ap.add_argument("--tenant", default=None,
                    help="tenant label(s) for per-tenant SLO accounting: "
                         "a single label, or a comma-separated list "
                         "cycled across the workload")
    ap.add_argument("--warmup", action="store_true",
                    help="warm the service's program for every bucket in "
                         "[--min-n, --max-n] before admitting traffic (on "
                         "the card: an eager engine iteration and CUDA "
                         "graphs of one); warmed buckets also enable "
                         "neighbour-bucket admission routing when the "
                         "config's numerics are bucket-width invariant "
                         "(--draw-mode counter with --ants pinned)")
    ap.add_argument("--warmup-async", action="store_true",
                    help="--warmup on a background thread: traffic is "
                         "admitted at once and takes the engine's own path "
                         "until its bucket is warm")
    ap.add_argument("--cache-dir", default=None,
                    help="build and load the CUDA kernel library in this "
                         "directory: a second process over it loads the "
                         "build instead of compiling it")
    ap.add_argument("--bucket-ladder", default=None,
                    help="--warmup: explicit comma-separated bucket list "
                         "(default: batch.bucket_ladder over "
                         "[--min-n, --max-n])")
    ap.add_argument("--dry", action="store_true",
                    help="--warmup: warm the ladder, report the program "
                         "and cache stats as JSON and exit without running "
                         "a workload")
    ap.add_argument("--draw-mode", default="packed",
                    choices=["packed", "counter"],
                    help="per-(ant, city) randomness derivation: "
                         "'counter' makes draws invariant to the padded "
                         "bucket width")
    ap.add_argument("--ants", type=int, default=None,
                    help="pin the ant count (default: m = n_pad)")
    return ap


def main() -> None:
    ap = _parser()
    args = ap.parse_args()
    if args.dry and not args.warmup:
        ap.error("--dry requires --warmup")
    dev = _device.resolve(args.device)
    cfg = aco.ACOConfig(iterations=args.iterations, variant=args.variant,
                        selection=args.selection,
                        local_search=args.local_search, seed=args.seed,
                        m=args.ants, draw_mode=args.draw_mode,
                        use_pallas=args.use_pallas, sparse=args.sparse,
                        sparse_k=args.sparse_k,
                        sparse_overflow=args.sparse_overflow,
                        tau_dtype=args.tau_dtype, tau_round=args.tau_round,
                        metrics=args.metrics)
    mesh = None
    if args.shard:
        mesh = make_data_mesh(args.devices if args.device is None
                              else [dev] * (args.devices or 1))
    tel = obs.Telemetry(events_path=args.events_out,
                        profile_dir=args.profile_dir)
    tenants = (args.tenant.split(",") if args.tenant else None)
    server = None
    if args.cache_dir:
        enable_persistent_cache(args.cache_dir)
    programs = ProgramCache(telemetry=tel) if args.warmup else None
    ladder = ([int(x) for x in args.bucket_ladder.split(",")]
              if args.bucket_ladder else None)

    def _warm(svc) -> bool:
        """Run the warmup ladder; with --dry, print the report and tell
        the caller to skip the workload."""
        if programs is None:
            return False
        t0 = time.perf_counter()
        summary = svc.warm_programs(args.min_n, args.max_n, ladder=ladder,
                                    background=args.warmup_async
                                    and not args.dry)
        warm_s = time.perf_counter() - t0
        if not args.dry:
            if args.warmup_async:
                print("solve_serve: warmup started (background)",
                      file=sys.stderr)
            else:
                print(f"solve_serve: warmup done in {warm_s:.2f}s; kernel "
                      f"library {json.dumps(_build.LOADED)}",
                      file=sys.stderr)
            return False
        report = {
            "schema": "repro.solve_serve/v1",
            "dry": True,
            "warmup": summary,
            "stats": {"programs": programs.stats()},
        }
        if args.cache_dir:
            report["cache"] = persistent_cache_stats(args.cache_dir)
        report["kernels"] = dict(_build.LOADED)
        print(json.dumps(_round(report), indent=2), flush=True)
        return True

    try:
        tel.profile_start()
        if args.stream:
            if args.checkpoint_dir:
                ap.error("--checkpoint-dir is not supported with --stream "
                         "(streaming checkpointing is not implemented)")
            svc = StreamingSolverService(
                cfg, max_batch=args.max_batch, min_bucket=args.min_bucket,
                chunk=args.chunk, patience=args.patience,
                max_waiting=args.max_waiting,
                per_instance_hyper=args.per_instance_hyper, mesh=mesh,
                telemetry=tel, snapshot_every=args.stats_every,
                programs=programs, device=dev)
            server = _start_metrics_server(args, tel, svc)
            if _warm(svc):
                return
            trace = make_poisson_trace(args.num_instances, args.arrival_rate,
                                       args.min_n, args.max_n,
                                       seed=args.seed,
                                       iterations=args.iterations,
                                       tenants=tenants)
            results = replay_trace(svc, trace)
            _report(sorted(results, key=lambda r: r.request_id), svc.stats)
        else:
            if args.per_instance_hyper:
                ap.error("--per-instance-hyper requires --stream")
            svc = SolverService(cfg, max_batch=args.max_batch,
                                min_bucket=args.min_bucket,
                                patience=args.patience,
                                checkpoint_dir=args.checkpoint_dir,
                                mesh=mesh, telemetry=tel,
                                programs=programs, device=dev)
            server = _start_metrics_server(args, tel, svc)
            if _warm(svc):
                return
            for i, inst in enumerate(make_workload(
                    args.num_instances, args.min_n, args.max_n, args.seed)):
                svc.submit(inst, tenant=(tenants[i % len(tenants)]
                                         if tenants else None))
            results = svc.run()
            _report(results, svc.stats)
        if args.metrics_out:
            tel.write_metrics(args.metrics_out, extra={"stats": svc.stats})
        if args.trace_out:
            tel.write_trace(args.trace_out)
        # hold last: the report and exports are already on disk, so the
        # external scraper can kill us whenever it has what it needs
        _hold_endpoint(args, server)
    except UnsupportedKernelRoute as e:
        # one actionable line instead of a traceback: the route checker's
        # message already says which flag to drop
        print(f"solve_serve: {e}", file=sys.stderr)
        sys.exit(2)
    finally:
        if server is not None:
            server.close()
        tel.close()


if __name__ == "__main__":
    main()
