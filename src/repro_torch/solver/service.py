"""Queue-and-scheduler solver service: submit -> bucket -> batch -> collect.

The PyTorch port of ``repro.solver.service`` in drain mode.  The service
accumulates solve requests, groups them by padded bucket size
(``batch.bucket_size``), slices each bucket into batches of at most
``max_batch`` instances and runs each batch through the batched engine.

Crash recovery: with ``checkpoint_dir`` set, each batch job runs under the
``runtime.Supervisor``: the job advances in ``ckpt_chunk``-iteration
chunks and checkpoints the stacked state (with the stagnation counters
and, under ``cfg.metrics``, the metrics rows) after each chunk; on a
failure the supervisor restores the newest checkpoint and resumes.  The
engine freezes instances against their *absolute* iteration count, so the
chunked trajectory is the uninterrupted one
(tests/test_torch_service.py injects a crash and asserts equal results).

The service runs on the card unless ``device="cpu"`` is passed.  With a
``mesh`` (``launch.mesh.Mesh``) every batch job's instance axis is
sharded over the mesh's positions by the placement layer, and the
results stay bitwise what the single-device service returns; the batches
are built on the mesh's first position unless a device is given.  The
program cache (``programs=``, ``warm_programs``) is not ported yet
(ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import uuid
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from .. import obs
from ..checkpoint import CheckpointManager
from ..core import aco, pheromone, tsp
from ..obs import metrics as obs_metrics
from ..runtime.supervisor import Supervisor, SupervisorConfig
from . import batch as batch_mod
from . import engine


@dataclasses.dataclass
class SolveRequest:
    request_id: int
    instance: tsp.TSPInstance
    iterations: int
    seed: int
    submitted_at: float
    # request-scoped correlation fields: neither reaches the solve
    trace_id: str = ""
    tenant: Optional[str] = None


@dataclasses.dataclass
class SolveResult:
    request_id: int
    name: str
    n: int
    bucket: int
    best_len: float
    best_tour: np.ndarray          # (n,) real-city permutation (tail trimmed)
    iterations: int
    gap_pct: Optional[float]       # vs known optimum, when available
    latency_s: float               # submit -> result
    solve_s: float                 # batch wall time (shared by batch peers)
    # deadline eviction belongs to the streaming service; a drain result
    # always completes
    expired: bool = False
    # the final metrics row (obs.metrics.FIELDS) with cfg.metrics, else None
    metrics: Optional[dict] = None
    trace_id: str = ""
    tenant: Optional[str] = None


class SolverService:
    """Bucket-scheduling request loop over the batched engine."""

    def __init__(self, cfg: Optional[aco.ACOConfig] = None,
                 max_batch: int = 8, min_bucket: int = 16,
                 patience: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 ckpt_chunk: int = 25, mesh=None,
                 telemetry: Optional[obs.Telemetry] = None,
                 programs=None, device: _device.DeviceLike = None):
        if programs is not None:
            raise NotImplementedError(
                "SolverService(programs=...): the program cache is not "
                "ported yet (ROADMAP queue 1 item 15)")
        if cfg is None:
            cfg = aco.ACOConfig()
        if cfg.deposit in pheromone.NOT_PORTED:
            raise NotImplementedError(
                f"deposit strategy {cfg.deposit!r} is not ported yet "
                "(ROADMAP queue 1 item 4)")
        if cfg.deposit not in pheromone.STRATEGIES:
            raise ValueError(f"unknown deposit strategy {cfg.deposit!r}; "
                             f"supported: {', '.join(pheromone.STRATEGIES)}")
        if cfg.sparse:
            # fail at construction, not mid-drain: batched slots are
            # always padded (masked), and a mesh needs the dense placement
            # layer
            from ..kernels import ops as kops
            kops.check_kernel_route(masked=True, sparse=True,
                                    selection=cfg.selection,
                                    local_search=cfg.local_search,
                                    construction=cfg.construction,
                                    mesh=mesh is not None)
        self.mesh = mesh
        self.device = _device.resolve(device) \
            if device is not None or mesh is None else mesh.device_list()[0]
        self.cfg = cfg
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.patience = patience
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_chunk = ckpt_chunk
        # service phases (bucket / prep / dispatch / collect) land as spans
        # on one timeline, the job lifecycle as JSON-lines events; the
        # default private bundle costs microseconds
        self.tel = telemetry if telemetry is not None else obs.Telemetry()
        self.slo = obs.SloTracker(self.tel.registry)
        self._t_started = time.perf_counter()
        self._queue: list[SolveRequest] = []
        self._next_id = 0
        self._jobs_run = 0
        self.stats: dict = {}

    # ------------------------------------------------------------- queue
    def submit(self, instance: tsp.TSPInstance,
               iterations: Optional[int] = None,
               seed: Optional[int] = None,
               tenant: Optional[str] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        trace_id = uuid.uuid4().hex[:16]
        self._queue.append(SolveRequest(
            request_id=rid, instance=instance,
            iterations=iterations if iterations is not None
            else self.cfg.iterations,
            seed=seed if seed is not None else self.cfg.seed + rid,
            submitted_at=time.perf_counter(),
            trace_id=trace_id, tenant=tenant))
        self.tel.registry.counter("submitted").inc()
        self.slo.on_submit(tenant)
        self.tel.events.emit("submit", request_id=rid, trace_id=trace_id,
                             tenant=obs.SloTracker.tenant_label(tenant),
                             n=instance.n,
                             bucket=self._route_bucket(instance.n))
        return rid

    def _route_bucket(self, n: int) -> int:
        """Admission bucket for an ``n``-city instance: its power-of-two
        bucket."""
        return batch_mod.bucket_size(n, self.min_bucket)

    def warm_programs(self, min_n: int, max_n: int,
                      background: bool = False, ladder=None):
        raise NotImplementedError(
            "warm_programs: the program cache is not ported yet (ROADMAP "
            "queue 1 item 15)")

    @property
    def devices(self) -> int:
        """Mesh positions a job's instance axis spreads over (1 without a
        mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    @property
    def pending(self) -> int:
        return len(self._queue)

    def health(self) -> dict:
        """Liveness view for a ``/healthz`` endpoint."""
        return {
            "mode": "drain",
            "uptime_s": time.perf_counter() - self._t_started,
            "pending": self.pending,
            "jobs_run": self._jobs_run,
            "devices": self.devices,
            "tenants": sorted(self.slo.tenants),
        }

    # --------------------------------------------------------- scheduler
    def run(self) -> list[SolveResult]:
        """Drain the queue: bucket, batch, solve, collect.  Returns results
        in request order; throughput and latency stats land in
        ``self.stats``."""
        queue, self._queue = self._queue, []
        if not queue:
            return []
        t0 = time.perf_counter()
        with self.tel.tracer.span("bucket", requests=len(queue)):
            by_bucket: dict[int, list[SolveRequest]] = {}
            for req in queue:
                b = self._route_bucket(req.instance.n)
                by_bucket.setdefault(b, []).append(req)

        results: list[SolveResult] = []
        batch_count = 0
        for bucket in sorted(by_bucket):
            reqs = by_bucket[bucket]
            for i in range(0, len(reqs), self.max_batch):
                results.extend(self._run_job(bucket,
                                             reqs[i:i + self.max_batch]))
                batch_count += 1
        wall = time.perf_counter() - t0
        lat = [r.latency_s for r in results]
        self.stats = {
            "requests": len(queue),
            "devices": self.devices,
            "batches": batch_count,
            "buckets": {str(b): len(rs)
                        for b, rs in sorted(by_bucket.items())},
            "wall_s": wall,
            "instances_per_s": len(queue) / max(wall, 1e-9),
            "latency_mean_s": float(np.mean(lat)),
            "latency_max_s": float(np.max(lat)),
            "uptime_s": time.perf_counter() - self._t_started,
            "tenants": self.slo.summary(),
        }
        return sorted(results, key=lambda r: r.request_id)

    # --------------------------------------------------------------- job
    def _run_job(self, bucket: int,
                 reqs: list[SolveRequest]) -> list[SolveResult]:
        instances = [r.instance for r in reqs]
        seeds = [r.seed for r in reqs]
        budgets = [r.iterations for r in reqs]
        max_it = max(budgets)
        job_id = self._jobs_run
        self._jobs_run += 1
        dev = self.device

        thread = f"b{bucket}"
        with self.tel.tracer.span("prep", thread=thread, n=len(reqs)):
            if self.cfg.sparse:
                b = batch_mod.make_sparse_batch(instances, self.cfg.sparse_k,
                                                bucket, device=dev)

                def init():
                    return engine.init_sparse_states(instances, self.cfg,
                                                     seeds, bucket, dev)
                kind, ewt = "sparse", b.ewt
            else:
                b = batch_mod.make_batch(instances, bucket, self.cfg.nn_k,
                                         device=dev)

                def init():
                    return engine.init_states(instances, self.cfg, seeds,
                                              bucket, device=dev)
                kind, ewt = "dense", "EUC_2D"
        metrics_on = self.cfg.metrics

        t0 = time.perf_counter()
        for req in reqs:               # queue wait ends at job dispatch
            self.slo.on_admit(req.tenant, t0 - req.submitted_at)
        with self.tel.tracer.span("dispatch", thread=thread, job=job_id,
                                  bucket=bucket, batch=len(reqs),
                                  max_iters=max_it,
                                  request_ids=[r.request_id
                                               for r in reqs]):
            if self.checkpoint_dir:
                # checkpointed state = (ColonyState, stagnation counters,
                # [metrics rows]): everything the chunked loop carries
                # survives chunk boundaries, so patience runs and the
                # final metrics compose exactly with an uninterrupted run
                chunk = self.ckpt_chunk
                mgr = CheckpointManager(
                    os.path.join(self.checkpoint_dir,
                                 f"job{job_id:04d}_b{bucket}"),
                    async_write=False)

                def init_st():
                    zeros = torch.zeros((len(reqs),), dtype=torch.int32,
                                        device=dev)
                    if metrics_on:
                        return (init(), zeros,
                                obs_metrics.zeros_batch(len(reqs), dev))
                    return (init(), zeros)

                sup = Supervisor(
                    SupervisorConfig(total_steps=math.ceil(max_it / chunk),
                                     ckpt_every=1),
                    mgr, init_st,
                    lambda st, i: engine.run_batch(
                        b.problem, st[0], budgets, self.cfg, chunk,
                        self.patience, st[1], mesh=self.mesh, kind=kind,
                        ewt=ewt, mets=st[2] if metrics_on else None))
                out_st = sup.run()
            else:
                out_st = engine.run_batch(b.problem, init(), budgets,
                                          self.cfg, max_it, self.patience,
                                          mesh=self.mesh, kind=kind, ewt=ewt)
            states = out_st[0]
            mets = out_st[2] if metrics_on else None
            for d in {dev} if self.mesh is None else \
                    set(self.mesh.device_list()):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        solve_s = time.perf_counter() - t0

        with self.tel.tracer.span("collect", thread=thread, job=job_id):
            now = time.perf_counter()
            out = []
            for k, (req, row) in enumerate(
                    zip(reqs, engine.collect(states, b))):
                opt = row["known_optimum"]
                latency_s = now - req.submitted_at
                out.append(SolveResult(
                    request_id=req.request_id, name=row["name"],
                    n=row["n"], bucket=bucket, best_len=row["best_len"],
                    best_tour=row["best_tour"],
                    iterations=row["iterations"],
                    gap_pct=(100.0 * (row["best_len"] / opt - 1.0)
                             if opt else None),
                    latency_s=latency_s, solve_s=solve_s,
                    metrics=(obs_metrics.to_host(mets, k)
                             if mets is not None else None),
                    trace_id=req.trace_id, tenant=req.tenant))
                self.slo.on_outcome(req.tenant, "completed", latency_s,
                                    None)
                self.tel.events.emit(
                    "harvest", request_id=req.request_id,
                    trace_id=req.trace_id,
                    tenant=obs.SloTracker.tenant_label(req.tenant),
                    bucket=bucket, job_id=job_id,
                    best_len=row["best_len"],
                    iterations=row["iterations"], latency_s=latency_s)
            self.tel.registry.counter("completed").inc(len(out))
            self.tel.events.emit("job", job_id=job_id, bucket=bucket,
                                 batch=len(out), solve_s=solve_s,
                                 request_ids=[r.request_id for r in reqs])
        return out
