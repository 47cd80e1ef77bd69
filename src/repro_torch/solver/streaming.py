"""Continuous-batching streaming solver: slot-based engine, mid-run admission.

The PyTorch port of ``repro.solver.streaming``.  The drain service
(``service.py``) admits work only at batch boundaries: a straggler holds
its whole batch, and newly arrived requests wait for the full drain.  Here
each bucket owns a *resident* stacked ``ColonyState`` of ``max_batch``
slots on the card, and a step loop runs fixed-size chunks of the batched
engine (``engine.run_batch``).  After every chunk, slots whose done mask
fires (absolute iteration count >= budget, or patience) are harvested into
``SolveResult``s and refilled from the waiting queue by **state surgery**:
the slot's rows of every resident tensor are overwritten in place
(``index_copy_``) with a fresh padded problem and ``engine.init_state``.

Exactness contract (tests/test_torch_streaming.py): any request solved
through a pool gives bitwise the same best tour as a solo
``engine.run_batch`` call with the same seed, because

- refill surgery writes only the refilled slots' rows: sibling slots'
  tensors are untouched bitwise;
- ``run_batch`` freezes finished slots against their own *absolute*
  iteration count, so chunked stepping composes exactly with one long
  call;
- a refilled slot starts from exactly the state a solo run starts from
  (``engine.init_state``: tau0 from the real instance, PRNGKey(seed)).

On the fused kernel route a chunk's engine iteration is one walk launch
and one update launch for the whole pool: an empty slot holds a frozen
budget-0 dummy (``random_instance(2)`` padded to the bucket) that the
kernels skip, so it costs no walk.  The done mask is read from the card
once a chunk (the (B,) iteration counts and stagnation counts together).

Admission control: waiting requests are ordered by (priority desc,
deadline asc, arrival); ``max_waiting`` bounds the queue (``submit``
raises AdmissionError).  A request whose deadline passes is evicted at the
next step, from the waiting queue or from its running slot (with the best
tour found so far), as an ``expired`` result.

Telemetry comes from the port's ``obs``: counters, gauges and bounded
histograms behind ``stats``, the slot lifecycle as JSON-lines events,
chunk dispatches and slot residencies as Chrome-trace spans, and with
``cfg.metrics`` the StepMetrics rows resident beside the state.

The service runs on the card unless ``device="cpu"`` is passed.  With a
``mesh`` (``launch.mesh.Mesh``) each bucket owns one resident pool per
mesh position, on that position's device; admission goes to the
least-occupied pool, and every step dispatches all pools' chunks before
it harvests any.  Requests are prepped on the service's device (the
mesh's first position unless a device is given) and copied to their
pool's device by the refill surgery.

Program cache (``programs=``, ``solver/programs.py``): a pool always steps
full-width (slots = max_batch, loop bound = chunk, in place), so one
warmed program per bucket (``warm_programs``) serves every chunk it
dispatches; admission stamps each request's bucket once, at submit: the
native one, or the nearest larger warmed one where routing there is
bitwise exact (``programs.check_neighbour_route``).
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import obs, tree
from ..core import aco, pheromone, tsp
from ..obs import metrics as obs_metrics
from . import batch as batch_mod
from . import engine, placement
from .service import SolveResult


class AdmissionError(RuntimeError):
    """Raised by submit() when the waiting queue is at max_waiting."""


@dataclasses.dataclass
class StreamRequest:
    request_id: int
    instance: tsp.TSPInstance
    iterations: int
    seed: int
    priority: int = 0                  # higher admitted first
    # Latency budget in seconds after submission; tighter budgets admit
    # first.  Once ``expires_at`` (submitted_at + deadline) passes, the
    # request is evicted at the next step as an ``expired`` result.
    deadline: Optional[float] = None
    hyper: Optional[aco.Hyper] = None
    submitted_at: float = 0.0
    expires_at: Optional[float] = None  # absolute perf_counter seconds
    # request-scoped correlation fields: neither reaches the solve
    trace_id: str = ""
    tenant: Optional[str] = None
    # admission bucket, stamped once at submit
    bucket: int = 0
    # Prepped ahead of admission: the padded Problem and fresh ColonyState
    # the refill surgery writes into a slot.
    prob: Optional[aco.Problem] = None
    state: Optional[aco.ColonyState] = None

    def order_key(self):
        return (-self.priority,
                self.expires_at if self.expires_at is not None
                else float("inf"),
                self.request_id)

    def prep(self, bucket: int, cfg: aco.ACOConfig, nn_k: int,
             device: _device.DeviceLike = None) -> None:
        if self.prob is None:
            dev = _device.resolve(device)
            self.prob = batch_mod.padded_problem(
                self.instance, bucket, nn_k, self.hyper, dev)
            self.state = engine.init_state(
                self.instance, cfg, self.seed, bucket, self.hyper, dev)


def _tensor_fields(problem: aco.Problem) -> tuple:
    """A Problem's tensor leaves (dist, eta, nn, hyper) in field order."""
    return (problem.dist, problem.eta, problem.nn, problem.hyper)


class StreamingPool:
    """One bucket's resident slots: a stacked Problem/ColonyState of
    ``slots`` rows on the device, stepped together; empty slots hold a
    frozen dummy (budget 0 => done => never stepped)."""

    def __init__(self, bucket: int, slots: int, cfg: aco.ACOConfig,
                 patience: int = 0, nn_k: Optional[int] = None,
                 per_instance_hyper: bool = False,
                 device: _device.DeviceLike = None,
                 telemetry: Optional[obs.Telemetry] = None,
                 dev_label: str = "dev0",
                 slo: Optional[obs.SloTracker] = None,
                 programs=None):
        self.bucket = bucket
        self.slots = slots
        self.cfg = cfg
        self.patience = patience
        self.nn_k = cfg.nn_k if nn_k is None else nn_k
        self.per_instance_hyper = per_instance_hyper
        self.tel = telemetry if telemetry is not None else obs.Telemetry()
        self.dev_label = dev_label
        self.slo = slo if slo is not None else obs.SloTracker(
            self.tel.registry)
        self.device = _device.resolve(device)
        dev = self.device
        # a warmed chunk program runs through the cache; None keeps the
        # engine's own path
        self.programs = programs
        # Dummy resident for empty slots: budget 0 keeps it frozen, so its
        # trajectory is never observed; it only has to be finite.
        dummy = tsp.random_instance(2, seed=0)
        dhyper = aco.Hyper.make(cfg, device=dev) if per_instance_hyper \
            else None
        dprob = batch_mod.padded_problem(dummy, bucket, self.nn_k, dhyper,
                                         dev)
        dstate = engine.init_state(dummy, cfg, 0, bucket, dhyper, dev)
        dist, eta, nn, hyper = tree.stack([_tensor_fields(dprob)] * slots)
        self.problem: aco.Problem = aco.Problem(
            dist, eta, nn, n_actual=(dprob.n_actual,) * slots, hyper=hyper)
        self.states: aco.ColonyState = tree.stack([dstate] * slots)
        self.budgets: list[int] = [0] * slots          # host: absolute
        self.since = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # metrics rows ride next to the resident state (None when off)
        self.mets = obs_metrics.zeros_batch(slots, dev) if cfg.metrics \
            else None
        self.requests: list[Optional[StreamRequest]] = [None] * slots
        self.filled_at: list[float] = [0.0] * slots
        self.fills = 0
        self.chunks = 0

    # ---------------------------------------------------------- occupancy
    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self.requests)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    # ------------------------------------------------------ refill surgery
    def fill_slots(self, assignments: Sequence[tuple[int, StreamRequest]]
                   ) -> None:
        """Overwrite each (slot, request) pair's rows of the resident
        tensors with a fresh problem + initial state: one ``index_copy_``
        per leaf; sibling slots are untouched bitwise."""
        if not assignments:
            return
        now = time.perf_counter()
        probs, states, idx = [], [], []
        n_actual = list(self.problem.n_actual)
        for i, req in assignments:
            assert self.requests[i] is None, f"slot {i} occupied"
            req.prep(self.bucket, self.cfg, self.nn_k, self.device)
            probs.append(_tensor_fields(req.prob))
            states.append(req.state)
            idx.append(i)
            n_actual[i] = req.prob.n_actual
            self.budgets[i] = req.iterations
            self.requests[i] = req
            self.filled_at[i] = now
            self.fills += 1
        ix = torch.tensor(idx, dtype=torch.long, device=self.device)

        def put(dst, src):            # prepped on the service's device
            dst.index_copy_(0, ix, src.to(dst.device))
        tree.map(put, _tensor_fields(self.problem), tree.stack(probs))
        tree.map(put, self.states, tree.stack(states))
        self.problem = self.problem._replace(n_actual=tuple(n_actual))
        self.since.index_fill_(0, ix, 0)
        if self.mets is not None:          # fresh slot, fresh metrics row
            tree.map(lambda M: M.index_fill_(0, ix, 0), self.mets)
        for i, req in assignments:        # resident copies own the data now
            req.prob = req.state = None
            wait_s = now - req.submitted_at
            self.slo.on_admit(req.tenant, wait_s)
            self.tel.events.emit(
                "admit", request_id=req.request_id,
                trace_id=req.trace_id,
                tenant=obs.SloTracker.tenant_label(req.tenant), slot=i,
                bucket=self.bucket, device=self.dev_label,
                n=req.instance.n, iterations=req.iterations,
                wait_s=wait_s)
            # retroactive queue-wait span (submit -> admit)
            self.tel.tracer.complete(
                f"queued req{req.request_id}",
                self.tel.tracer.to_us(req.submitted_at), wait_s * 1e6,
                process="queue", thread=f"b{self.bucket}",
                request_id=req.request_id, trace_id=req.trace_id,
                tenant=obs.SloTracker.tenant_label(req.tenant))

    # ------------------------------------------------------------ stepping
    def step_chunk(self, chunk: int) -> None:
        """Advance every active slot by up to ``chunk`` iterations, in
        place on the resident tensors.  The dispatch is recorded as a span
        on this pool's device/bucket track (it covers the host's launches,
        not the card's time) and, under a live profile, as a named
        profiler step."""
        with self.tel.tracer.span("chunk_dispatch", process=self.dev_label,
                                  thread=f"b{self.bucket}",
                                  occupied=self.occupied, chunk=chunk,
                                  request_ids=[r.request_id
                                               for r in self.requests
                                               if r is not None]), \
                self.tel.step_annotation("chunk_step", step_num=self.chunks):
            out = engine.run_batch(
                self.problem, self.states, self.budgets, self.cfg, chunk,
                self.patience, self.since, donate=True, mets=self.mets,
                programs=self.programs)
        if self.cfg.metrics:
            self.states, self.since, self.mets = out
        else:
            self.states, self.since = out
        self.chunks += 1

    def harvest(self) -> list[SolveResult]:
        """Collect every occupied slot whose done mask fired (one device
        read: the iteration and stagnation counts together); free the slot
        (budget 0 refreezes it) so the next admit round can refill it."""
        it, since = torch.stack([self.states.iteration,
                                 self.since]).cpu().numpy()
        done = it >= np.asarray(self.budgets)
        if self.patience > 0:
            done = done | (since >= self.patience)
        return self._free_slots(
            [i for i, r in enumerate(self.requests)
             if r is not None and done[i]])

    def evict_expired(self, now: float) -> list[SolveResult]:
        """Evict occupied slots whose request deadline has passed: the
        freed slot returns a SolveResult flagged ``expired`` holding the
        best tour found so far, and budget 0 refreezes the slot so the
        ordinary refill surgery can reuse it."""
        hits = [i for i, r in enumerate(self.requests)
                if r is not None and r.expires_at is not None
                and r.expires_at <= now]
        return self._free_slots(hits, expired=True)

    def _free_slots(self, hits: list[int],
                    expired: bool = False) -> list[SolveResult]:
        if not hits:
            return []
        now = time.perf_counter()
        # copies: on the CPU .cpu() is the resident tensor itself, which
        # the next refill overwrites in place
        it, lens, tours = (x.to("cpu", copy=True).numpy() for x in (
            self.states.iteration, self.states.best_len,
            self.states.best_tour))
        mets = None if self.mets is None else \
            tree.map(lambda x: x.cpu(), self.mets)
        out = []
        for i in hits:
            req = self.requests[i]
            inst = req.instance
            opt = inst.known_optimum
            best_len = float(lens[i])
            latency_s = now - req.submitted_at
            tenant = obs.SloTracker.tenant_label(req.tenant)
            mrow = obs_metrics.to_host(mets, i) if mets is not None else None
            out.append(SolveResult(
                request_id=req.request_id, name=inst.name, n=inst.n,
                bucket=self.bucket, best_len=best_len,
                best_tour=batch_mod.trim_tour(tours[i], inst.n),
                iterations=int(it[i]),
                gap_pct=(100.0 * (best_len / opt - 1.0) if opt else None),
                latency_s=latency_s,
                solve_s=now - self.filled_at[i], expired=expired,
                metrics=mrow, trace_id=req.trace_id, tenant=req.tenant))
            self.requests[i] = None
            self.budgets[i] = 0
            self.slo.on_outcome(
                req.tenant,
                "expired_running" if expired else "completed",
                latency_s, req.deadline)
            # slot-lifecycle record + a residency span on this slot's
            # Chrome-trace lane (fill -> free, stamped retroactively)
            kind = "evict" if expired else "harvest"
            ev = dict(request_id=req.request_id, trace_id=req.trace_id,
                      tenant=tenant, slot=i,
                      bucket=self.bucket, device=self.dev_label,
                      iterations=int(it[i]), best_len=best_len,
                      latency_s=latency_s)
            if mrow is not None:
                ev["metrics"] = mrow
            self.tel.events.emit(kind, **ev)
            self.tel.tracer.complete(
                f"req{req.request_id}" + ("!" if expired else ""),
                self.tel.tracer.to_us(self.filled_at[i]),
                (now - self.filled_at[i]) * 1e6,
                process=self.dev_label, thread=f"b{self.bucket}/s{i}",
                request_id=req.request_id, trace_id=req.trace_id,
                tenant=tenant, n=inst.n,
                iterations=int(it[i]), expired=expired)
        return out

    def latest_metrics(self) -> dict[int, dict]:
        """Host view of the occupied slots' metrics rows (one read of the
        rows), keyed by request id.  Empty with ``cfg.metrics`` off."""
        if self.mets is None:
            return {}
        mets = tree.map(lambda x: x.cpu(), self.mets)
        return {r.request_id: obs_metrics.to_host(mets, i)
                for i, r in enumerate(self.requests) if r is not None}


class StreamingSolverService:
    """Mid-run-admission request loop over per-bucket streaming pools.

    submit() only queues; admission happens at each step(): waiting
    requests (priority/deadline ordered) fill free slots of their bucket's
    pool, every non-empty pool advances one chunk, finished slots are
    harvested and immediately refillable.  ``max_waiting`` bounds the
    queue (AdmissionError).  ``per_instance_hyper=True`` makes every slot
    carry alpha/beta/rho/q operands so one bucket mixes tuning profiles
    (requests may pass a Hyper or an override dict; others run the config
    profile); it runs on the pure route only.  Requests whose ``deadline``
    passes are evicted from the waiting queue and from running slots at the
    next step(), returned as ``expired`` results and counted in stats().
    """

    def __init__(self, cfg: Optional[aco.ACOConfig] = None,
                 max_batch: int = 8, min_bucket: int = 16, chunk: int = 5,
                 patience: int = 0, max_waiting: Optional[int] = None,
                 per_instance_hyper: bool = False, mesh=None,
                 telemetry: Optional[obs.Telemetry] = None,
                 snapshot_every: float = 0.0, programs=None,
                 device: _device.DeviceLike = None):
        if cfg is None:
            cfg = aco.ACOConfig()
        from ..kernels import ops as kops
        if cfg.use_pallas and per_instance_hyper:
            # per-slot Hyper operands need run-time exponents; the kernels
            # take host ones: fail eagerly with the kernels' typed error
            kops.check_kernel_route(hyper=True, tau_dtype=cfg.tau_dtype)
        if per_instance_hyper and cfg.tau_dtype != "fp32":
            kops.check_kernel_route(hyper=True, tau_dtype=cfg.tau_dtype)
        if cfg.sparse:
            # slot surgery assumes dense (n, n) ColonyState buffers
            kops.check_kernel_route(sparse=True, streaming=True,
                                    selection=cfg.selection,
                                    local_search=cfg.local_search,
                                    construction=cfg.construction)
        if cfg.deposit not in pheromone.STRATEGIES:
            raise ValueError(f"unknown deposit strategy {cfg.deposit!r}; "
                             f"supported: {', '.join(pheromone.STRATEGIES)}")
        if chunk < 1:
            raise ValueError(f"chunk {chunk} < 1")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting {max_waiting} < 1")
        self.cfg = cfg
        self.device = _device.resolve(device) \
            if device is not None or mesh is None else mesh.device_list()[0]
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.chunk = chunk
        self.patience = patience
        self.max_waiting = max_waiting
        self.per_instance_hyper = per_instance_hyper
        # Prep (padded Problem + initial state, about 12 MB on the card at
        # bucket 1024) is eager only for the head of the queue, so a deep
        # backlog does not pin O(waiting * n_pad^2) device memory.
        self.prep_ahead = 4 * max_batch
        # one pool per mesh position and bucket; without a mesh one pool
        # per bucket on the service's device (the bare ``dev0`` label)
        self.mesh = mesh
        self._devices = mesh.device_list() if mesh is not None else [None]
        self._pools: dict[int, list[StreamingPool]] = {}
        self._waiting: list[StreamRequest] = []
        self._next_id = 0
        self.tel = telemetry if telemetry is not None else obs.Telemetry()
        self.snapshot_every = snapshot_every
        self.slo = obs.SloTracker(self.tel.registry)
        self.programs = programs
        self._t_started = time.perf_counter()
        self._c_submitted = self.tel.registry.counter("submitted")
        self._c_rejected = self.tel.registry.counter("rejected")
        self._c_completed = self.tel.registry.counter("completed")
        self._c_expired_running = self.tel.registry.counter("expired_running")
        self._c_expired_waiting = self.tel.registry.counter("expired_waiting")
        self._h_latency = self.tel.registry.histogram("latency_s")
        self._h_occupancy = self.tel.registry.histogram("occupancy")
        self._per_bucket_done: dict[int, int] = {}
        self._t_first_submit: Optional[float] = None
        self._t_last_harvest: Optional[float] = None
        self._t_last_snapshot: Optional[float] = None

    # -------------------------------------------------------------- queue
    def submit(self, instance: tsp.TSPInstance,
               iterations: Optional[int] = None,
               seed: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               hyper: Union[aco.Hyper, dict, None] = None,
               tenant: Optional[str] = None) -> int:
        """Queue a request; returns its id.  Raises AdmissionError when the
        waiting queue is full (resident slots don't count).  ``deadline``
        is a latency budget in seconds from now: it orders admission
        (tighter first) and, once exceeded, the request is evicted at the
        next step() as an ``expired`` result.  ``tenant`` is an
        observability label only."""
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline {deadline} <= 0")
        if self.max_waiting is not None and \
                len(self._waiting) >= self.max_waiting:
            self._c_rejected.inc()
            self.slo.on_reject(tenant)
            self.tel.events.emit("reject", waiting=len(self._waiting),
                                 max_waiting=self.max_waiting,
                                 tenant=obs.SloTracker.tenant_label(tenant))
            raise AdmissionError(
                f"waiting queue full ({len(self._waiting)} >= "
                f"{self.max_waiting})")
        its = iterations if iterations is not None else self.cfg.iterations
        if its < 1:
            raise ValueError(f"iterations {its} < 1")
        if hyper is not None and not self.per_instance_hyper:
            raise ValueError("per-request hyper requires "
                             "per_instance_hyper=True")
        if self.per_instance_hyper:
            if isinstance(hyper, dict):
                hyper = aco.Hyper.make(self.cfg, **hyper, device=self.device)
            elif hyper is None:
                hyper = aco.Hyper.make(self.cfg, device=self.device)
        rid = self._next_id
        self._next_id += 1
        now = time.perf_counter()
        if self._t_first_submit is None:
            self._t_first_submit = now
        req = StreamRequest(
            request_id=rid, instance=instance, iterations=its,
            seed=seed if seed is not None else self.cfg.seed + rid,
            priority=priority, deadline=deadline, hyper=hyper,
            submitted_at=now,
            expires_at=None if deadline is None else now + deadline,
            trace_id=uuid.uuid4().hex[:16], tenant=tenant)
        req.bucket = self._route_bucket(instance.n)
        if len(self._waiting) < self.prep_ahead:
            req.prep(req.bucket, self.cfg, self.cfg.nn_k, self.device)
        self._waiting.append(req)
        self._c_submitted.inc()
        self.slo.on_submit(tenant)
        self.tel.events.emit(
            "submit", request_id=rid, trace_id=req.trace_id,
            tenant=obs.SloTracker.tenant_label(tenant), n=instance.n,
            bucket=req.bucket,
            iterations=its, priority=priority, deadline=deadline)
        return rid

    def _route_bucket(self, n: int) -> int:
        """Admission bucket for an ``n``-city instance: the native
        power-of-two bucket, possibly routed into the nearest larger warmed
        bucket by an attached program cache (bitwise exact per
        ``programs.check_neighbour_route``)."""
        native = batch_mod.bucket_size(n, self.min_bucket)
        if self.programs is None:
            return native
        return self.programs.route_bucket(native, self.cfg, kind="dense")

    def warm_programs(self, min_n: int, max_n: int,
                      background: bool = False, ladder=None):
        """Warm the chunk step's program for every bucket instances in
        [min_n, max_n] can land in (``batch.bucket_ladder``; ``ladder``
        overrides with an explicit bucket list): the signature the resident
        pools dispatch, slots = max_batch, loop bound = chunk, in place,
        metrics per ``cfg.metrics``."""
        if self.programs is None:
            raise ValueError("no ProgramCache attached (programs=)")
        if ladder is None:
            ladder = batch_mod.bucket_ladder(min_n, max_n, self.min_bucket)
        return self.programs.warm(
            ladder, batch=self.max_batch, cfg=self.cfg,
            max_iters=self.chunk, patience=self.patience, donate=True,
            kind="dense", hyper=self.per_instance_hyper,
            background=background, device=self.device)

    @property
    def waiting(self) -> int:
        return len(self._waiting)

    @property
    def resident(self) -> int:
        return sum(p.occupied for p in self._all_pools())

    @property
    def busy(self) -> bool:
        return bool(self._waiting) or self.resident > 0

    # ---------------------------------------------------------- admission
    def _bucket_pools(self, bucket: int) -> list[StreamingPool]:
        if bucket not in self._pools:
            self._pools[bucket] = [
                StreamingPool(bucket, self.max_batch, self.cfg,
                              self.patience,
                              per_instance_hyper=self.per_instance_hyper,
                              device=self.device if dev is None else dev,
                              telemetry=self.tel,
                              dev_label=placement.device_label(dev, j),
                              slo=self.slo,
                              # warmed on the service's device, which is
                              # the first position's unless one is given
                              programs=self.programs if j == 0 else None)
                for j, dev in enumerate(self._devices)]
        return self._pools[bucket]

    def _all_pools(self):
        for pools in self._pools.values():
            yield from pools

    def _admit(self) -> int:
        """Move waiting requests (priority desc, deadline asc, arrival)
        into free slots of their bucket's pools, each to the currently
        least-occupied pool.  Returns #admitted."""
        if not self._waiting:
            return 0
        self._waiting.sort(key=StreamRequest.order_key)
        fills: dict[tuple[int, int], list[tuple[int, StreamRequest]]] = {}
        free: dict[int, list[list[int]]] = {}   # bucket -> per-pool slots
        leftover: list[StreamRequest] = []
        for req in self._waiting:
            b = req.bucket
            if b not in free:
                free[b] = [p.free_slots() for p in self._bucket_pools(b)]
            j = max(range(len(free[b])), key=lambda k: len(free[b][k]))
            if free[b][j]:
                fills.setdefault((b, j), []).append((free[b][j].pop(0), req))
            else:
                leftover.append(req)
        self._waiting = leftover
        n = 0
        for (b, j), assignments in fills.items():
            self._pools[b][j].fill_slots(assignments)
            n += len(assignments)
        # prefetch prep for the queue head (the next harvest's refills)
        for req in leftover[:self.prep_ahead]:
            if req.prob is None:
                req.prep(req.bucket, self.cfg, self.cfg.nn_k, self.device)
        return n

    # ----------------------------------------------------------- eviction
    def _evict_expired(self) -> list[SolveResult]:
        """Drop deadline-expired requests from the waiting queue (never
        ran: empty tour, inf length) and from running slots (partial best
        so far); every eviction returns a SolveResult flagged ``expired``
        and is counted in stats()."""
        now = time.perf_counter()
        out: list[SolveResult] = []
        if any(r.expires_at is not None and r.expires_at <= now
               for r in self._waiting):
            keep: list[StreamRequest] = []
            for req in self._waiting:
                if req.expires_at is not None and req.expires_at <= now:
                    wait_s = now - req.submitted_at
                    bucket = req.bucket
                    out.append(SolveResult(
                        request_id=req.request_id, name=req.instance.name,
                        n=req.instance.n, bucket=bucket,
                        best_len=float("inf"),
                        best_tour=np.zeros((0,), np.int32), iterations=0,
                        gap_pct=None, latency_s=wait_s,
                        solve_s=0.0, expired=True,
                        trace_id=req.trace_id, tenant=req.tenant))
                    self._c_expired_waiting.inc()
                    self.slo.on_outcome(req.tenant, "expired_waiting",
                                        wait_s, req.deadline)
                    tenant = obs.SloTracker.tenant_label(req.tenant)
                    self.tel.events.emit(
                        "evict_waiting", request_id=req.request_id,
                        trace_id=req.trace_id, tenant=tenant,
                        n=req.instance.n, wait_s=wait_s)
                    # never admitted: its whole life is one queue span
                    self.tel.tracer.complete(
                        f"queued req{req.request_id}!",
                        self.tel.tracer.to_us(req.submitted_at),
                        wait_s * 1e6, process="queue",
                        thread=f"b{bucket}",
                        request_id=req.request_id, trace_id=req.trace_id,
                        tenant=tenant, expired=True)
                else:
                    keep.append(req)
            self._waiting = keep
        for pool in self._all_pools():
            if pool.occupied:
                got = pool.evict_expired(now)
                self._c_expired_running.inc(len(got))
                out.extend(got)
        return out

    # ------------------------------------------------------------ stepping
    def step(self) -> list[SolveResult]:
        """One scheduler tick: evict expired deadlines, admit, advance
        every non-empty pool by one chunk, harvest.  Returns newly
        finished results (completion order, expired ones included).  Every
        pool's chunk is launched before any harvest reads a result back."""
        results: list[SolveResult] = list(self._evict_expired())
        self._admit()
        stepped: list[StreamingPool] = []
        for pool in self._all_pools():
            if pool.occupied == 0:
                continue
            self._h_occupancy.observe(pool.occupied / pool.slots)
            pool.step_chunk(self.chunk)
            stepped.append(pool)
        for pool in stepped:
            results.extend(pool.harvest())      # first device read-back
        if results:
            done = [r for r in results if not r.expired]
            if done:
                self._t_last_harvest = time.perf_counter()
                self._c_completed.inc(len(done))
            for r in done:
                self._h_latency.observe(r.latency_s)
                self._per_bucket_done[r.bucket] = \
                    self._per_bucket_done.get(r.bucket, 0) + 1
        self._maybe_snapshot()
        return results

    def _maybe_snapshot(self) -> None:
        """Periodic ``stats_snapshot`` event every ``snapshot_every``
        seconds (the first at once): the stats dict, a monotonic
        ``uptime_s`` and, with ``cfg.metrics``, every resident request's
        live metrics row."""
        if self.snapshot_every <= 0:
            return
        now = time.perf_counter()
        if self._t_last_snapshot is not None and \
                now - self._t_last_snapshot < self.snapshot_every:
            return
        self._t_last_snapshot = now
        ev = {"stats": self.stats, "uptime_s": now - self._t_started}
        if self.cfg.metrics:
            live = {}
            for pool in self._all_pools():
                live.update({str(k): v
                             for k, v in pool.latest_metrics().items()})
            ev["resident_metrics"] = live
        self.tel.events.emit("stats_snapshot", **ev)

    def run_until_drained(self, max_steps: Optional[int] = None
                          ) -> list[SolveResult]:
        """Step until queue and pools are empty (or max_steps)."""
        out: list[SolveResult] = []
        steps = 0
        while self.busy:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    # --------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Lifecycle totals, occupancy and latency from the telemetry
        registry: means and rates from the histograms' exact running
        aggregates, percentiles over their bounded recent window."""
        lat = self._h_latency
        completed = self._c_completed.value
        expired = (self._c_expired_waiting.value
                   + self._c_expired_running.value)
        wall = None
        if self._t_first_submit is not None and \
                self._t_last_harvest is not None:
            wall = self._t_last_harvest - self._t_first_submit
        programs = ({"programs": self.programs.stats()}
                    if self.programs is not None else {})
        return {
            **programs,
            "submitted": self._c_submitted.value,
            "rejected": self._c_rejected.value,
            "completed": completed,
            "expired": expired,
            "expired_waiting": self._c_expired_waiting.value,
            "expired_running": self._c_expired_running.value,
            "waiting": self.waiting,
            "resident": self.resident,
            "devices": len(self._devices),
            "pools": sum(len(ps) for ps in self._pools.values()),
            "chunks": sum(p.chunks for p in self._all_pools()),
            "fills": sum(p.fills for p in self._all_pools()),
            "slots": {str(b): sum(p.slots for p in ps)
                      for b, ps in sorted(self._pools.items())},
            "buckets": {str(b): c
                        for b, c in sorted(self._per_bucket_done.items())},
            "occupancy_mean": self._h_occupancy.mean(),
            "instances_per_s": (completed / wall
                                if wall and wall > 0 else 0.0),
            "latency_mean_s": lat.mean(),
            "latency_p50_s": lat.percentile(50),
            "latency_p95_s": lat.percentile(95),
            "latency_max_s": lat.max(),
            "uptime_s": time.perf_counter() - self._t_started,
            "tenants": self.slo.summary(),
        }

    def health(self) -> dict:
        """Liveness + occupancy view for a ``/healthz`` endpoint: one row
        per resident pool plus queue depth."""
        return {
            "mode": "streaming",
            "uptime_s": time.perf_counter() - self._t_started,
            "waiting": self.waiting,
            "resident": self.resident,
            "devices": len(self._devices),
            "tenants": sorted(self.slo.tenants),
            "pools": [
                {"bucket": p.bucket, "device": p.dev_label,
                 "slots": p.slots, "occupied": p.occupied,
                 "chunks": p.chunks, "fills": p.fills}
                for p in self._all_pools()],
        }


# ------------------------------------------------------------ trace replay
@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One arrival of a replayable request trace."""
    at: float                      # seconds from replay start
    instance: tsp.TSPInstance
    iterations: int
    seed: int
    priority: int = 0
    tenant: Optional[str] = None   # observability label


def make_poisson_trace(num: int, rate: float, min_n: int, max_n: int,
                       seed: int = 0,
                       iterations: Union[int, Sequence[int]] = 20,
                       tenants: Optional[Sequence[str]] = None
                       ) -> list[TraceItem]:
    """Poisson arrivals (exponential inter-arrival at ``rate`` req/s) of
    mixed circle/random instances; ``iterations`` may be a sequence of
    budgets cycled over the arrivals, and ``tenants`` cycles tenant labels
    the same way (the labels change nothing else)."""
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(num):
        t += float(rng.exponential(1.0 / rate))
        n = int(rng.randint(min_n, max_n + 1))
        inst = (tsp.circle_instance(n, seed=seed + i) if i % 2 == 0
                else tsp.random_instance(n, seed=seed + i))
        its = (int(iterations) if np.isscalar(iterations)
               else int(iterations[i % len(iterations)]))
        out.append(TraceItem(at=t, instance=inst, iterations=its,
                             seed=seed + i,
                             tenant=(tenants[i % len(tenants)]
                                     if tenants else None)))
    return out


def replay_trace(svc: StreamingSolverService, trace: Sequence[TraceItem]
                 ) -> list[SolveResult]:
    """Wall-clock replay: submit each item once its arrival time passes,
    stepping the service in between (mid-run admission); sleeps only when
    the service is idle and the next arrival is in the future.  When the
    waiting queue is full (``max_waiting``), the item is held and retried
    after the next step, so ``rejected`` is not inflated by retries."""
    start = time.perf_counter()
    i = 0
    results: list[SolveResult] = []
    while i < len(trace) or svc.busy:
        now = time.perf_counter() - start
        while i < len(trace) and trace[i].at <= now:
            if svc.max_waiting is not None and \
                    svc.waiting >= svc.max_waiting:
                break          # queue full: step to drain, then retry
            it = trace[i]
            svc.submit(it.instance, iterations=it.iterations,
                       seed=it.seed, priority=it.priority,
                       tenant=it.tenant)
            i += 1
        if svc.busy:
            results.extend(svc.step())
        elif i < len(trace):
            time.sleep(max(0.0, trace[i].at - (time.perf_counter() - start)))
    return results
