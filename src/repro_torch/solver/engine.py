"""Batched multi-instance ACO engine: one call advances B colonies.

The PyTorch port of ``repro.solver.engine``.  ``run_batch`` advances a
stacked state of B colonies by up to ``max_iters`` iterations.  Each
engine iteration steps every still-active colony once; a colony whose
absolute budget is reached (or which went ``patience`` iterations without
improving) is frozen, so its trajectory -- the PRNG key included -- does
not depend on how long the rest of the batch runs.  The loop ends as soon
as every colony is done.

Design, two routes:

- the kernel routes that take the instance axis step the whole stack at
  once, whatever the number of active slots:
  - dense (``aco.batched_route``: ``use_pallas=True``, the fused or the
    ``pallas`` construction, with or without local search, no Hyper;
    AS, MMAS or ACS over any ``tau_dtype``, metrics on or off):
    ``core.aco.colony_step_batch``, one ``split`` of the (B, 2) keys, one
    ``fused_walk`` launch (``pallas``: one ``choice_info`` launch and one
    ``tour_select`` launch a step), one local-search pass over the
    stack's tours (one ``two_opt_best`` launch a round; the ``ls_every``
    gate per slot, from the host mirror of the slots' iterations) and one
    ``pheromone_update`` launch per engine iteration;
  - sparse (``kind="sparse"`` on ``sparse.aco.batched_route``:
    ``use_pallas=True``, the standard construction; AS, MMAS or ACS over
    any ``tau_dtype``): ``sparse.aco.sparse_colony_step_batch``, one
    ``sparse_walk`` launch per engine iteration and the epilogue over
    (B, ...) pages.
  The kernels skip a finished slot, and only the active slots' rows are
  written back (the reference's ``where``-freeze).  ``colony_step`` and
  ``sparse_colony_step`` are those functions' B = 1 cases, so batched ==
  solo is bitwise by construction;
- every other route (the pure routes, Hyper) is a host loop over the
  active slots, each calling ``core.aco.colony_step`` (or
  ``sparse.aco.sparse_colony_step``) on that slot's view of the stacked
  tensors.

The done mask is read from the card once per engine iteration, and only
under ``patience``: budgets compare against a host mirror of each slot's
iteration count.

``mesh=`` shards the instance axis over the positions of a
``launch.mesh.Mesh`` (``placement.run_batch_sharded``), bitwise the
single-device call per instance.

``programs=`` (a ``programs.ProgramCache``) runs a warmed signature
through its ``EngineProgram`` (``aot_lower``): on the card, CUDA graphs of
one engine iteration (``stack_iteration``) replayed over static buffers,
bitwise this module's own loop.
"""
from __future__ import annotations

import gc
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from .. import tree
from ..core import aco, sampling, tsp
from ..sparse import aco as sparse_aco
from ..sparse.store import SparseColonyState
from . import batch as batch_mod


def init_state(instance: tsp.TSPInstance, cfg: aco.ACOConfig, seed: int,
               n_pad: int, hyper: Optional[aco.Hyper] = None,
               device: _device.DeviceLike = None) -> aco.ColonyState:
    """Fresh single-slot ColonyState padded to ``n_pad``: tau0 from the
    *real* instance (and the Hyper's rho for MMAS), as a solo run starts."""
    dev = _device.resolve(device)
    tau0 = aco.initial_tau(
        instance, cfg, rho=None if hyper is None else float(hyper.rho))
    return aco.ColonyState(
        tau=aco.make_tau(torch.full((n_pad, n_pad), float(np.float32(tau0)),
                                    dtype=torch.float32, device=dev), cfg),
        best_tour=torch.arange(n_pad, dtype=torch.int32, device=dev),
        best_len=torch.tensor(np.float32(np.inf), device=dev),
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        key=sampling.prng_key(seed, dev),
    )


def init_states(instances: Sequence[tsp.TSPInstance], cfg: aco.ACOConfig,
                seeds: Sequence[int], n_pad: int,
                hypers: Optional[Sequence[Optional[aco.Hyper]]] = None,
                device: _device.DeviceLike = None) -> aco.ColonyState:
    """Stacked ColonyState for a bucket: tau0 from each *real* instance."""
    dev = _device.resolve(device)
    if hypers is None:
        hypers = [None] * len(instances)
    return tree.stack([init_state(inst, cfg, seed, n_pad, h, dev)
                       for inst, seed, h in zip(instances, seeds, hypers)])


def init_sparse_states(instances: Sequence[tsp.TSPInstance],
                       cfg: aco.ACOConfig, seeds: Sequence[int],
                       n_pad: int, device: _device.DeviceLike = None
                       ) -> SparseColonyState:
    """Stacked SparseColonyState for one (n_pad, k) bucket: tau0 per
    *real* instance, one slot per instance."""
    dev = _device.resolve(device)
    return tree.stack([sparse_aco.init_sparse_colony(inst, cfg, seed, n_pad,
                                                     device=dev)
                       for inst, seed in zip(instances, seeds)])


def _host_ints(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.tolist()]
    return [int(v) for v in x]


def _check_aligned(problem, states, b: int) -> None:
    """The walk kernel reads 16-byte chunks aligned in the flat array: a
    slot's view must start on a 16-byte boundary (it does for every bucket
    of ``batch.bucket_size``); the slot is never copied to make it so."""
    views = (problem.dist[b], problem.eta[b]) + tuple(
        tree.flatten(tree.index(states.tau, b)))
    if any(v.data_ptr() % 16 for v in views):
        raise ValueError(
            f"slot {b} of a (B, {problem.dist.shape[-1]}, "
            f"{problem.dist.shape[-1]}) stack is not 16-byte aligned; use a "
            "power-of-two bucket (batch.bucket_size)")


def run_batch(problem, states, budgets, cfg: aco.ACOConfig, max_iters: int,
              patience: int = 0, since: Optional[torch.Tensor] = None,
              donate: bool = False, mesh=None, instance_spec: str = "data",
              kind: str = "dense", ewt: str = "EUC_2D", mets=None,
              programs=None):
    """Advance B colonies by up to ``max_iters`` more iterations each.

    problem: the stacked ``Problem`` (``kind="dense"``) or ``SparseProblem``
    (``kind="sparse"``, with the bucket's rounding rule ``ewt``) of a
    batch.  budgets: (B,) *absolute* per-instance iteration targets
    (a tensor or a sequence of ints), compared against each slot's
    iteration count, so chunked calls compose exactly with one long call.
    patience: >0 also stops an instance after that many consecutive
    non-improving iterations.  since: (B,) int32 counts of consecutive
    non-improving iterations from a previous chunk (default zeros),
    returned updated.  mets: with ``cfg.metrics``, (B,)-stacked
    ``obs.StepMetrics`` rows from a previous chunk (default zeros),
    frozen under the same mask and returned as a third element.
    donate: update ``states``/``since``/``mets`` in place and return them;
    without it the inputs are left as they were.  The results are the
    same either way.
    mesh: a ``launch.mesh.Mesh`` routes the call through the placement
    layer: the instance axis is padded to a multiple of the mesh's
    ``instance_spec`` axis with already-done phantom slots and split over
    its positions, bitwise the single-device call per instance.  Sparse
    batches are rejected there, as in the reference.
    programs: an attached ``programs.ProgramCache`` runs a warmed
    signature's ``EngineProgram`` (``jit_cache_hit``) and this function's
    own path otherwise (``jit_cache_miss``), bitwise the same either way.
    On the mesh route the cache only keeps the hit/miss accounting.

    Returns ``(states, since)``, or ``(states, since, mets)`` with metrics.
    """
    if mesh is not None:
        if kind == "sparse":
            from ..kernels import ops as kops
            kops.check_kernel_route(sparse=True, mesh=True,
                                    selection=cfg.selection,
                                    local_search=cfg.local_search,
                                    construction=cfg.construction)
        from . import placement
        if programs is not None:
            from . import programs as programs_mod
            programs.note_mesh_call(programs.signature(
                problem, states, budgets, cfg, max_iters, patience, donate,
                kind, ewt, mesh=programs_mod.mesh_label(mesh)))
        return placement.run_batch_sharded(problem, states, budgets, cfg,
                                           max_iters, patience, since, mesh,
                                           instance_spec, donate, mets)
    if programs is not None:
        return programs.call(_run_batch_local, problem, states, budgets, cfg,
                             max_iters, patience, since, mets, kind=kind,
                             ewt=ewt, donate=donate)
    return _run_batch_local(problem, states, budgets, cfg, max_iters,
                            patience, since, mets, kind=kind, ewt=ewt,
                            donate=donate)


def _prepare(states, budgets, cfg: aco.ACOConfig, since, mets):
    """A call's host budgets, and its ``since``/``mets`` (zeros when not
    given; ``mets`` None with metrics off)."""
    dev = states.key.device
    n_slots = states.key.shape[0]
    budgets_h = _host_ints(budgets)
    if len(budgets_h) != n_slots:
        raise ValueError(f"{len(budgets_h)} budgets for {n_slots} slots")
    if since is None:
        since = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    if not cfg.metrics:
        mets = None
    elif mets is None:
        from ..obs import metrics as obs_metrics
        mets = obs_metrics.zeros_batch(n_slots, dev)
    return budgets_h, since, mets


def stack_step(problem, cfg: aco.ACOConfig, kind: str, ewt: str):
    """The whole-stack step of a route that takes the instance axis,
    ``step(states, active flags, n_actual, host iteration counts)``
    (``colony_step_batch`` or ``sparse_colony_step_batch``), or None for a
    route stepped one slot at a time."""
    if kind == "dense" and aco.batched_route(cfg, problem):
        def step(s, active, n_act, its):
            return aco.colony_step_batch(problem, s, cfg, active=active,
                                         n_actual=n_act, iterations=its)
        return step
    if kind == "sparse" and sparse_aco.batched_route(cfg):
        def step(s, active, n_act, its):
            del its
            return sparse_aco.sparse_colony_step_batch(
                problem, s, cfg, ewt, active=active, n_actual=n_act)
        return step
    return None


def _run_batch_local(problem, states, budgets, cfg: aco.ACOConfig,
                     max_iters: int, patience: int = 0, since=None, mets=None,
                     kind: str = "dense", ewt: str = "EUC_2D",
                     donate: bool = False):
    """``run_batch`` on one device, without a program cache."""
    if kind not in ("dense", "sparse"):
        raise ValueError(f"unknown kind {kind!r}")
    n_slots = states.key.shape[0]
    budgets_h, since, mets = _prepare(states, budgets, cfg, since, mets)
    metrics_on = mets is not None

    if kind == "dense" and cfg.use_pallas:
        for b in range(n_slots):
            _check_aligned(problem, states, b)
    it_h = _host_ints(states.iteration)            # one read per call
    step_stack = stack_step(problem, cfg, kind, ewt)
    if step_stack is not None:
        if not donate:
            states = tree.map(torch.clone, states)
            since = since.clone()
            mets = tree.map(torch.clone, mets) if metrics_on else None
        n_act = aco.slot_n_actual(problem, states.key.device)
        index_of: dict = {}             # active pattern -> device indices

        def iterate(flags, its):
            idx = None
            if flags is not None:
                if flags not in index_of:
                    index_of[flags] = active_index(flags, states.key.device)
                idx = index_of[flags]
            stack_iteration(step_stack, states, since, mets, flags, n_act,
                            its, idx)
        _run_stack(since, budgets_h, it_h, max_iters, patience, iterate)
        if metrics_on:
            return states, since, mets
        return states, since

    if kind == "sparse":
        def step(p, s):
            return sparse_aco.sparse_colony_step(p, s, cfg, ewt)
    else:
        def step(p, s):
            return aco.colony_step(p, s, cfg)

    probs = [batch_mod.slot_problem(problem, b) for b in range(n_slots)]
    slots = [tree.index(states, b) for b in range(n_slots)]
    since_s = [since[b] for b in range(n_slots)]
    mets_s = [tree.index(mets, b) for b in range(n_slots)] \
        if metrics_on else None
    stepped = set()
    for _ in range(max_iters):
        stalled = [False] * n_slots
        if patience > 0:                           # one read an iteration
            stalled = [s >= patience
                       for s in torch.stack(since_s).tolist()]
        active = [b for b in range(n_slots)
                  if it_h[b] < budgets_h[b] and not stalled[b]]
        if not active:
            break
        for b in active:
            out = step(probs[b], slots[b])
            new = out[0]
            improved = new.best_len < slots[b].best_len
            since_s[b] = torch.where(improved, torch.zeros_like(since_s[b]),
                                     since_s[b] + 1)
            if metrics_on:
                mets_s[b] = out[2]._replace(stagnation=since_s[b])
            slots[b] = new
            it_h[b] += 1
            stepped.add(b)

    if donate:
        for b in sorted(stepped):
            tree.map(lambda dst, src: dst.copy_(src),
                     tree.index(states, b), slots[b])
            since[b] = since_s[b]
            if metrics_on:
                tree.map(lambda dst, src: dst.copy_(src),
                         tree.index(mets, b), mets_s[b])
        out_states, out_since, out_mets = states, since, mets
    else:
        out_states = tree.stack(slots)
        out_since = torch.stack(since_s)
        out_mets = tree.stack(mets_s) if metrics_on else None
    if metrics_on:
        return out_states, out_since, out_mets
    return out_states, out_since


def active_index(flags, device) -> torch.Tensor:
    """The indices of the set flags of an active pattern, on ``device``."""
    return torch.tensor([b for b, a in enumerate(flags) if a],
                        dtype=torch.long, device=device)


def stack_iteration(step_stack, states, since, mets, flags, n_act, its,
                    idx=None) -> None:
    """One engine iteration on a route that takes the instance axis, in
    place: step the whole stack (``flags``: B host flags, None when every
    slot is active) and write back the rows of the slots that were active
    (all of them with one ``copy_`` per leaf when every slot was; else
    ``idx``, the active slots' indices on the device).  Both the engine's
    loop and a program's eager iterations and graph captures run this."""
    out = step_stack(states, flags, n_act, its)
    new = out[0]
    improved = new.best_len < states.best_len
    new_since = torch.where(improved, torch.zeros_like(since), since + 1)
    fresh = [new, new_since]
    held = [states, since]
    if mets is not None:
        fresh.append(out[2]._replace(stagnation=new_since))
        held.append(mets)
    if flags is None:
        tree.map(lambda dst, src: dst.copy_(src), held, fresh)
    else:
        tree.map(lambda dst, src: dst.index_copy_(
            0, idx, src.index_select(0, idx)), held, fresh)


def _run_stack(since, budgets_h, it_h, max_iters, patience, iterate) -> None:
    """The engine's loop on a route that takes the instance axis: each
    engine iteration finds the active slots on the host (reading ``since``
    from the card under ``patience``) and calls ``iterate(flags, host
    iteration counts)``, which steps the stack in place."""
    n_slots = len(budgets_h)
    for _ in range(max_iters):
        stalled = [False] * n_slots
        if patience > 0:                           # one read an iteration
            stalled = [s >= patience for s in since.tolist()]
        act = tuple(it_h[b] < budgets_h[b] and not stalled[b]
                    for b in range(n_slots))
        if not any(act):
            break
        iterate(None if all(act) else act, tuple(it_h))
        for b in range(n_slots):
            it_h[b] += act[b]


def _tensor_fields(problem) -> list[str]:
    """The fields of a (dense or sparse) problem that hold tensors."""
    return [f for f in problem._fields
            if isinstance(getattr(problem, f), torch.Tensor)]


def graph_route(problem, cfg: aco.ACOConfig, kind: str, device) -> bool:
    """Whether an engine iteration of this signature can be captured as a
    CUDA graph: a CUDA device and a route whose whole iteration is
    launched without reading the card.  These stay eager: the per-slot
    routes (pure, Hyper), local search (it reads its improvement flags
    each round, and gates slots on their iteration counts), and the
    ``pallas`` construction (its step loop is bounded by the slots' host
    ``n_actual``, which a graph would fix)."""
    if torch.device(device).type != "cuda":
        return False
    if kind == "sparse":
        return sparse_aco.batched_route(cfg)
    return (aco.batched_route(cfg, problem)
            and cfg.construction == "data_parallel"
            and cfg.local_search == "none")


class _Graph:
    """One captured engine iteration: the graph, the kernel launches it
    replays, the sparse walk's fallback count it computes (None on the
    dense route), its memory pool and the allocator's growth across the
    capture."""

    def __init__(self, graph, launches: dict, fallbacks, pool,
                 pool_bytes: int):
        self.graph = graph
        self.launches = launches
        self.fallbacks = fallbacks
        self.pool = pool
        self.pool_bytes = pool_bytes

    def replay(self) -> None:
        self.graph.replay()
        from ..kernels import _build
        _build.add_launches(self.launches)
        if self.fallbacks is not None:
            from ..sparse import construct
            construct.walk.fallbacks = construct.walk.fallbacks \
                + self.fallbacks


_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}
# the most graphs (active patterns) one program keeps: a bucket of B slots
# has 2^B patterns, of which a job or a pool meets a few
MAX_GRAPHS = 8


def capture_graph(fn, device, pool=None) -> _Graph:
    """Capture what ``fn()`` launches on ``device`` as a CUDA graph (into
    ``pool`` when given) and return it; nothing runs until a replay.
    Captures are serialised, each on the device's capture stream, and
    record their launches rather than count them (``_build``).  No other
    thread may synchronise the whole device meanwhile: the program cache
    captures only in the thread that runs its programs."""
    from ..kernels import _build
    from ..sparse import construct
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        stream = _CAPTURE_STREAMS.get(device)
        if stream is None:
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        torch.cuda.synchronize(device)
        # the capture empties the allocator's cache first: empty it here
        # so the growth measured is the pool's
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        held = construct.walk.fallbacks
        construct.walk.fallbacks = 0
        try:
            with _build.recording_launches() as launches, \
                    torch.cuda.graph(graph, pool=pool, stream=stream,
                                     capture_error_mode="thread_local"):
                fn()
            fallbacks = construct.walk.fallbacks
        finally:
            construct.walk.fallbacks = held
        grown = torch.cuda.memory_reserved(device) - before
    return _Graph(graph, launches,
                  fallbacks if isinstance(fallbacks, torch.Tensor) else None,
                  graph.pool(), grown)


class EngineProgram:
    """A warmed ``run_batch`` signature: the port's counterpart of the
    reference's compiled engine program (``aot_lower``).

    On a ``graph_route`` it owns static buffers of the signature's shapes
    (the stacked problem, states, stagnation counts, metrics rows and the
    slots' ``n_actual``) and CUDA graphs of one engine iteration
    (``stack_iteration``) over them, one per active pattern: the
    all-active one at warm time, another the second time its pattern is
    seen, up to ``MAX_GRAPHS``.  ``run`` copies a call's operands into the
    buffers once, replays the graph of each iteration whose pattern has
    one and runs the same iteration eagerly otherwise, then copies out:
    the results are bitwise the engine's own.  The graphs of one program
    share one memory pool (their replays never overlap).  Any other
    signature (the CPU, the routes ``graph_route`` keeps eager) runs the
    engine's own path."""

    def __init__(self, problem, states, since, mets, cfg: aco.ACOConfig,
                 kind: str, ewt: str):
        self.cfg, self.kind, self.ewt = cfg, kind, ewt
        self.device = states.key.device
        self.graphed = graph_route(problem, cfg, kind, self.device)
        self.graphs: dict = {}          # active pattern -> _Graph
        self._seen: dict = {}           # active pattern -> sightings
        self._index: dict = {}          # active pattern -> device indices
        self._failed: set = set()       # patterns whose capture raised
        self._lock = threading.Lock()
        self._pool = None
        self._templates = (problem, states, since, mets)
        if not self.graphed:
            return
        self.problem = problem._replace(**{
            f: getattr(problem, f).clone() for f in _tensor_fields(problem)})
        self.states = tree.map(torch.clone, states)
        self.since = since.clone()
        self.mets = tree.map(torch.clone, mets)
        self.n_act = aco.slot_n_actual(problem, self.device)
        self._step = stack_step(self.problem, cfg, kind, ewt)

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.graphs.values())

    def warm(self, capture: bool = True) -> None:
        """One eager engine iteration on the template operands (it builds
        and loads the kernels and fills the per-pattern device caches and
        the allocator), then, on a graph route, the all-active capture;
        with ``capture=False`` (a warm on a background thread) that capture
        waits for the program's first run, in the thread that serves: a
        capture must not overlap another thread's device-wide
        synchronisation."""
        problem, states, since, mets = self._templates
        self._templates = None
        if not self.graphed:
            n_slots = states.key.shape[0]
            _run_batch_local(problem, states, [1] * n_slots, self.cfg, 1,
                             0, since, mets, kind=self.kind, ewt=self.ewt)
            return
        with self._lock:
            self._iterate_eager(None, ())
            self._seen[None] = 1
            if capture:
                self._capture(None)

    def _iterate_eager(self, flags, its) -> None:
        if flags is not None and flags not in self._index:
            self._index[flags] = active_index(flags, self.device)
        stack_iteration(self._step, self.states, self.since, self.mets,
                        flags, self.n_act, its, self._index.get(flags))

    def _capture(self, flags) -> _Graph:
        g = capture_graph(lambda: self._iterate_eager(flags, ()),
                          self.device, self._pool)
        if self._pool is None:
            self._pool = g.pool
        self.graphs[flags] = g
        return g

    def _iterate(self, flags, its) -> None:
        g = self.graphs.get(flags)
        seen = self._seen.get(flags, 0)
        self._seen[flags] = seen + 1
        if g is None and seen and flags not in self._failed and \
                len(self.graphs) < MAX_GRAPHS:
            try:
                g = self._capture(flags)
            except Exception:
                self._failed.add(flags)
                raise
        if g is not None:
            g.replay()
        else:
            self._iterate_eager(flags, its)

    def run(self, problem, states, budgets, max_iters: int,
            patience: int = 0, since=None, mets=None, donate: bool = False):
        """``run_batch`` of this signature, bitwise the engine's own."""
        if not self.graphed:
            return _run_batch_local(problem, states, budgets, self.cfg,
                                    max_iters, patience, since, mets,
                                    kind=self.kind, ewt=self.ewt,
                                    donate=donate)
        budgets_h, since, mets = _prepare(states, budgets, self.cfg, since,
                                          mets)
        if (problem.n_actual is None) != (self.n_act is None):
            raise ValueError("the call's problem and the warmed one differ "
                             "in masking")
        pairs = [(getattr(self.problem, f), getattr(problem, f))
                 for f in _tensor_fields(self.problem)]
        pairs += list(zip(tree.flatten(self.states), tree.flatten(states)))
        pairs.append((self.since, since))
        pairs += list(zip(tree.flatten(self.mets), tree.flatten(mets)))
        if any(d.shape != s.shape or d.dtype != s.dtype for d, s in pairs):
            raise ValueError("the call's operands do not have the warmed "
                             "signature's shapes")
        it_h = _host_ints(states.iteration)
        with self._lock:
            for dst, src in pairs:
                dst.copy_(src)
            if self.n_act is not None:
                self.n_act.copy_(torch.tensor(problem.n_actual,
                                              dtype=torch.int32))
            _run_stack(self.since, budgets_h, it_h, max_iters, patience,
                       self._iterate)
            if donate:
                out = (states, since, mets)
                tree.map(lambda dst, src: dst.copy_(src), list(out),
                         [self.states, self.since, self.mets])
            else:
                out = tree.map(torch.clone,
                               (self.states, self.since, self.mets))
        if mets is not None:
            return out
        return out[0], out[1]


def aot_lower(problem, states, budgets, cfg: aco.ACOConfig, max_iters: int,
              patience: int, since=None, mets=None, kind: str = "dense",
              ewt: str = "EUC_2D", donate: bool = False,
              capture: bool = True) -> EngineProgram:
    """The warmed program of the signature these operands give (the
    reference's ``aot_lower(...).compile()``: lowering and compiling are
    one step here): an ``EngineProgram`` whose ``run(problem, states,
    budgets, max_iters, patience, since, mets, donate)`` is bitwise
    ``run_batch``.  The operands are templates: their values do not
    matter, and their buffers are not touched.  ``capture=False`` leaves
    the all-active graph to the program's first run (``EngineProgram.
    warm``)."""
    del max_iters, patience, donate      # the signature's, not the graph's
    _, since, mets = _prepare(states, budgets, cfg, since, mets)
    prog = EngineProgram(problem, states, since, mets, cfg, kind, ewt)
    prog.warm(capture)
    return prog


def solve_instances(instances: Sequence[tsp.TSPInstance], cfg: aco.ACOConfig,
                    iterations: Optional[Sequence[int]] = None,
                    seeds: Optional[Sequence[int]] = None,
                    n_pad: Optional[int] = None, patience: int = 0,
                    nn_k: Optional[int] = None,
                    hypers: Optional[Sequence[aco.Hyper]] = None,
                    mesh=None, device: _device.DeviceLike = None):
    """One-shot: batch, init, run; all instances in one bucket.  Returns
    (stacked states, batch).

    ``hypers``: per-instance alpha/beta/rho/q profiles (``aco.Hyper``), so
    one bucket mixes tuning profiles.  ``mesh``: shard the instance axis
    over the mesh (placement layer); the batch is built on ``device``, or
    on the mesh's first position when no device is given.  ``cfg.sparse``
    runs the bucket on the O(n·k) paged representation (stacked
    SparseColonyState, SparseBatch); unsupported sparse combinations
    raise ``UnsupportedKernelRoute``.
    """
    dev = _device.resolve(device) if device is not None or mesh is None \
        else mesh.device_list()[0]
    instances = tuple(instances)
    its = list(iterations) if iterations is not None else \
        [cfg.iterations] * len(instances)
    sds = list(seeds) if seeds is not None else \
        [cfg.seed + i for i in range(len(instances))]
    if cfg.sparse:
        if hypers is not None and any(h is not None for h in hypers):
            from ..kernels import ops as kops
            kops.check_kernel_route(hyper=True, sparse=True)
        sb = batch_mod.make_sparse_batch(instances, cfg.sparse_k, n_pad,
                                         device=dev)
        sparse_aco.check_sparse_route(cfg, masked=True)
        sstates = init_sparse_states(instances, cfg, sds, sb.n_pad, dev)
        sstates = run_batch(sb.problem, sstates, its, cfg, int(max(its)),
                            patience, donate=True, mesh=mesh, kind="sparse",
                            ewt=sb.ewt)[0]
        return sstates, sb
    b = batch_mod.make_batch(instances, n_pad,
                             nn_k if nn_k is not None else cfg.nn_k,
                             hypers=hypers, device=dev)
    states = init_states(instances, cfg, sds, b.n_pad, hypers, dev)
    # freshly built states are never reused: update them in place
    states = run_batch(b.problem, states, its, cfg, int(max(its)),
                       patience, donate=True, mesh=mesh)[0]
    return states, b


def collect(states, b: batch_mod.Batch) -> list[dict]:
    """Host-side per-instance results with phantom tails trimmed; dense
    and sparse batches alike."""
    lens = states.best_len.cpu().tolist()
    its = states.iteration.cpu().tolist()
    tours = states.best_tour.cpu().numpy()
    out = []
    for i, inst in enumerate(b.instances):
        out.append({
            "name": inst.name,
            "n": inst.n,
            "best_len": float(lens[i]),
            "best_tour": batch_mod.trim_tour(tours[i], inst.n),
            "iterations": int(its[i]),
            "known_optimum": inst.known_optimum,
        })
    return out
