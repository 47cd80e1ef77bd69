"""Warmed program cache: keep the first request off the cold path.

The PyTorch port of ``repro.solver.programs``.  Every (bucket, batch,
config, kind, ewt, hyper-mode, donation, mesh) tuple the solver fabric
touches is one signature of ``engine.run_batch``; the first request that
needs one pays the cold path on the serving critical path.  Here that path
is the nvcc build of the kernel library, the first launches and
allocations, and the host's launch overhead of every engine iteration.
This module closes it on three layers:

1. **Persistent build** -- ``enable_persistent_cache`` points the kernel
   library's build root (``kernels._build``) at a directory, so a second
   process over the same directory loads the library instead of
   compiling it (the build is keyed by a digest of the sources and flags,
   so a stale directory is never wrong, only useless).
2. **Warmup ladder** -- ``ProgramCache.warm`` builds an
   ``engine.EngineProgram`` (``engine.aot_lower``) for every bucket of
   ``batch.bucket_ladder`` before the service takes traffic (optionally on
   a background thread): one eager engine iteration on template operands
   and, on the card's graph routes, a CUDA graph of one engine iteration
   for each active pattern of the slots.  ``engine.run_batch`` routes
   through ``ProgramCache.call``: a warmed signature runs its program
   (``jit_cache_hit``), anything else the engine's own path
   (``jit_cache_miss``), bitwise the same either way.
3. **Neighbour-bucket routing** -- ``route_bucket`` pads a request whose
   native bucket is *not* warmed into the nearest larger warmed bucket.
   The routed result is bitwise the native route's, which holds only under
   width-invariant randomness: ``check_neighbour_route`` gates it on
   ``cfg.draw_mode == "counter"``, a pinned ant count ``cfg.m``, no local
   search, no candidate-list construction, nearest rounding for quantised
   tau and no Partial-ACO on the sparse route.

Everything here runs on the card unless the caller asks for the CPU
(``device=``); on the CPU a warmed signature runs the engine's eager path
and counts a hit.
"""
from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple, Optional, Sequence

from .. import device as _device
from ..core import aco

MESH_NONE = "-"


def mesh_label(mesh=None) -> str:
    """Stable cache-key label for a topology: "-" for single-device,
    else the mesh's axis:size pairs."""
    if mesh is None:
        return MESH_NONE
    return ",".join(f"{k}:{v}" for k, v in mesh.shape.items())


class ProgramKey(NamedTuple):
    """Full static signature of one warmed ``engine.run_batch`` call: the
    padded bucket and batch width (operand shapes), the frozen
    ``ACOConfig``, the loop statics, the donation mode, dense/sparse kind
    and TSPLIB rounding rule, whether the problem carries per-instance
    Hyper operands, the mesh topology and the device the program's
    buffers live on."""
    n_pad: int
    batch: int
    cfg: aco.ACOConfig
    max_iters: int
    patience: int
    donate: bool
    kind: str          # "dense" | "sparse"
    ewt: str
    hyper: bool
    mesh: str          # mesh_label()
    device: str        # str(torch.device) of the operands


# ------------------------------------------------ persistent kernel build

def enable_persistent_cache(cache_dir: str) -> str:
    """Build and load the kernel library under ``cache_dir`` (process-wide;
    call before the first launch: once the library is loaded from another
    directory this raises).  A later process over the same directory
    loads the build instead of compiling it."""
    from ..kernels import _build
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_root(cache_dir)
    return cache_dir


def persistent_cache_stats(cache_dir: str) -> dict:
    """File count and byte total of a build directory (every level)."""
    files = 0
    size = 0
    if os.path.isdir(cache_dir):
        for root, _, names in os.walk(cache_dir):
            for name in names:
                p = os.path.join(root, name)
                if os.path.isfile(p):
                    files += 1
                    size += os.path.getsize(p)
    return {"dir": cache_dir, "files": files, "bytes": size}


# --------------------------------------------- neighbour-route support

def check_neighbour_route(cfg: aco.ACOConfig) -> None:
    """Raise ``UnsupportedKernelRoute`` unless neighbour-bucket routing is
    bitwise-exact for this config.

    The padding invariants (phantom cities at inf distance, masked
    lengths/deposits) make the *deterministic* numerics width-invariant;
    the conditions here close the *stochastic* side.
    """
    from ..kernels.ops import UnsupportedKernelRoute

    def reject(reason: str) -> None:
        raise UnsupportedKernelRoute(
            f"neighbour-bucket routing needs bucket-width-invariant "
            f"numerics: {reason}")

    if cfg.m is None:
        reject("cfg.m is None, so the ant count follows the padded bucket "
               "width (m = n_pad); pin cfg.m")
    if cfg.draw_mode != "counter":
        reject(f"draw_mode {cfg.draw_mode!r} derives per-(ant, city) "
               "randomness from flat array counters; use "
               "draw_mode='counter'")
    if cfg.local_search != "none":
        reject(f"local search {cfg.local_search!r} scans NN candidate "
               "lists of width min(nn_k, n_pad - 1), which varies per "
               "bucket")
    if cfg.sparse:
        if cfg.construction == "partial":
            reject("Partial-ACO windows are unpadded-only (masked "
                   "instances are rejected upstream)")
    elif cfg.construction in ("nn_list", "nn_list_eager"):
        reject("nn_list construction selects over candidate lists of "
               "width min(nn_k, n_pad - 1), which varies per bucket")
    from ..core import quant
    if quant.is_quantised(cfg.tau_dtype) and cfg.tau_round != "nearest":
        reject(f"tau_round {cfg.tau_round!r} draws rounding bits over the "
               "full (n_pad, n_pad) matrix; use tau_round='nearest'")


def neighbour_supported(cfg: aco.ACOConfig) -> bool:
    from ..kernels.ops import UnsupportedKernelRoute
    try:
        check_neighbour_route(cfg)
        return True
    except UnsupportedKernelRoute:
        return False


# ------------------------------------------------------- program cache

class ProgramCache:
    """Warmed engine programs keyed by their full static signature.

    One cache serves one service (drain or streaming): ``warm`` fills it
    over a bucket ladder, ``call`` is the hot path ``engine.run_batch``
    routes through, ``route_bucket`` is the admission-time neighbour
    lookup.  Thread-safe: the warmup may run on a background thread while
    the service admits traffic (misses take the engine's own path, so a
    half-warmed ladder is never wrong, only slower).

    ``iters_cap``: warmed drain programs carry this ``max_iters``;
    ``effective_max_iters`` canonicalises a drain job's max(budgets) up to
    the cap so jobs of different budget mixes share one program (the loop
    ends on the per-instance done masks, so a larger bound never changes
    the trajectory).
    """

    def __init__(self, telemetry=None, iters_cap: Optional[int] = None):
        from .. import obs
        self.tel = telemetry if telemetry is not None else obs.Telemetry()
        self.iters_cap = iters_cap
        self._lock = threading.Lock()
        self._programs: dict[ProgramKey, object] = {}
        self._warmed_buckets: dict[tuple[str, str], set[int]] = {}
        self._missed_keys: list[tuple] = []     # first-sight ring, bounded
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_errors: list[str] = []
        self._c_hit = self.tel.registry.counter("jit_cache_hit")
        self._c_miss = self.tel.registry.counter("jit_cache_miss")
        self._c_warm_s = self.tel.registry.counter("warmup_compile_s")
        self._c_warm_programs = self.tel.registry.counter("warmup_programs")

    # ---------------------------------------------------------- key/sig
    @staticmethod
    def signature(problem, states, budgets, cfg: aco.ACOConfig,
                  max_iters: int, patience: int, donate: bool,
                  kind: str, ewt: str, mesh: str = MESH_NONE) -> ProgramKey:
        """ProgramKey of one ``run_batch`` call, read off its operands."""
        return ProgramKey(
            n_pad=int(states.best_tour.shape[-1]),
            batch=len(budgets),
            cfg=cfg, max_iters=int(max_iters), patience=int(patience),
            donate=bool(donate), kind=kind, ewt=ewt,
            hyper=getattr(problem, "hyper", None) is not None,
            mesh=mesh, device=str(states.key.device))

    def effective_max_iters(self, want: int) -> int:
        """Canonical loop bound: the warm-time cap whenever it covers the
        requested budget (one shared program), the exact budget otherwise
        (a miss, but correct)."""
        if self.iters_cap is not None and want <= self.iters_cap:
            return self.iters_cap
        return want

    # ----------------------------------------------------------- warmup
    @staticmethod
    def _templates(bucket: int, batch: int, cfg: aco.ACOConfig, kind: str,
                   hyper: bool, device):
        """Template operands with exactly the production structure, built
        through the factories the services use (``batch.make_batch`` /
        ``engine.init_states``), so the warmed signature cannot drift from
        the live one."""
        from ..core import tsp
        from . import batch as batch_mod
        from . import engine
        insts = [tsp.circle_instance(bucket, seed=0)] * batch
        seeds = list(range(batch))
        if kind == "sparse":
            b = batch_mod.make_sparse_batch(insts, cfg.sparse_k, bucket,
                                            device=device)
            states = engine.init_sparse_states(insts, cfg, seeds, bucket,
                                               device)
            ewt = b.ewt
        else:
            hypers = [aco.Hyper.make(cfg, device=device)] * batch \
                if hyper else None
            b = batch_mod.make_batch(insts, bucket, cfg.nn_k, hypers=hypers,
                                     device=device)
            states = engine.init_states(insts, cfg, seeds, bucket, hypers,
                                        device)
            ewt = "EUC_2D"
        return b.problem, states, [0] * batch, ewt

    def warm_one(self, bucket: int, batch: int, cfg: aco.ACOConfig,
                 max_iters: int, patience: int, donate: bool,
                 kind: str = "dense", hyper: bool = False,
                 device: _device.DeviceLike = None,
                 capture: bool = True) -> float:
        """Warm one signature's program; returns its seconds (0.0 when the
        signature is already warmed).  ``capture=False`` (a background
        warm) leaves the CUDA-graph capture to the program's first run and
        does not synchronise the device."""
        from . import engine
        dev = _device.resolve(device)
        t0 = time.perf_counter()
        problem, states, budgets, ewt = self._templates(
            bucket, batch, cfg, kind, hyper, dev)
        key = self.signature(problem, states, budgets, cfg, max_iters,
                             patience, donate, kind, ewt)
        with self._lock:
            if key in self._programs:
                return 0.0
        prog = engine.aot_lower(problem, states, budgets, cfg, max_iters,
                                patience, kind=kind, ewt=ewt, donate=donate,
                                capture=capture)
        if dev.type == "cuda" and capture:
            import torch
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        with self._lock:
            self._programs[key] = prog
            self._warmed_buckets.setdefault((kind, MESH_NONE),
                                            set()).add(bucket)
        self._c_warm_s.inc(dt)
        self._c_warm_programs.inc()
        self.tel.tracer.complete(f"compile b{bucket}x{batch}",
                                 self.tel.tracer.to_us(t0), dt * 1e6,
                                 process="programs", thread=kind,
                                 bucket=bucket, batch=batch, donate=donate,
                                 graphs=len(prog.graphs),
                                 pool_bytes=prog.pool_bytes)
        return dt

    def warm_mesh_one(self, bucket: int, batch: int, cfg: aco.ACOConfig,
                      max_iters: int, patience: int, mesh,
                      donate: bool = False, kind: str = "dense",
                      hyper: bool = False,
                      device: _device.DeviceLike = None) -> float:
        """Warm the sharded route for one bucket by *running* a budget-0
        batch through the placement layer (the mesh route keeps no program
        here; with every budget at 0 the run steps nothing, so it costs
        only the placement's first-call work)."""
        from . import engine
        dev = _device.resolve(device) if device is not None \
            else mesh.device_list()[0]
        problem, states, budgets, ewt = self._templates(
            bucket, batch, cfg, kind, hyper, dev)
        label = mesh_label(mesh)
        with self._lock:
            if bucket in self._warmed_buckets.get((kind, label), set()):
                return 0.0
        t0 = time.perf_counter()
        engine.run_batch(problem, states, budgets, cfg, max_iters, patience,
                         donate=donate, mesh=mesh, kind=kind, ewt=ewt)
        dt = time.perf_counter() - t0
        with self._lock:
            self._warmed_buckets.setdefault((kind, label),
                                            set()).add(bucket)
        self._c_warm_s.inc(dt)
        self._c_warm_programs.inc()
        self.tel.tracer.complete(f"compile b{bucket}x{batch}@{label}",
                                 self.tel.tracer.to_us(t0), dt * 1e6,
                                 process="programs", thread=kind,
                                 bucket=bucket, batch=batch, mesh=label)
        return dt

    def warm(self, buckets: Sequence[int], batch: int, cfg: aco.ACOConfig,
             max_iters: int, patience: int = 0, donate: bool = False,
             kind: str = "dense", hyper: bool = False, mesh=None,
             background: bool = False, device: _device.DeviceLike = None):
        """Warm the whole bucket ladder; returns a summary dict, or -- with
        ``background=True`` -- the started thread (``wait()`` joins it;
        misses before it finishes take the engine's own path).  A
        background warm captures no CUDA graph: each program's all-active
        graph is captured at its first run, by the serving thread."""
        args = (tuple(buckets), batch, cfg, max_iters, patience, donate,
                kind, hyper, mesh, device, background)
        if background:
            t = threading.Thread(target=self._warm_ladder, args=args,
                                 name="programs-warmup", daemon=True)
            with self._lock:
                self._warm_thread = t
            t.start()
            return t
        return self._warm_ladder(*args)

    def _warm_ladder(self, buckets, batch, cfg, max_iters, patience,
                     donate, kind, hyper, mesh, device, background):
        per_bucket = {}
        t0 = time.perf_counter()
        for b in buckets:
            try:
                if mesh is not None:
                    per_bucket[b] = self.warm_mesh_one(
                        b, batch, cfg, max_iters, patience, mesh,
                        donate=donate, kind=kind, hyper=hyper, device=device)
                else:
                    per_bucket[b] = self.warm_one(
                        b, batch, cfg, max_iters, patience, donate,
                        kind=kind, hyper=hyper, device=device,
                        capture=not background)
            except Exception as e:            # noqa: BLE001 -- background
                # thread must not die silently; the bucket stays cold and
                # serve time takes the engine's own path
                with self._lock:
                    self._warm_errors.append(f"b{b}: {type(e).__name__}: {e}")
                self.tel.events.emit("warmup_error", bucket=b,
                                     error=f"{type(e).__name__}: {e}")
        summary = {"buckets": {str(b): round(s, 4)
                               for b, s in per_bucket.items()},
                   "batch": batch, "kind": kind,
                   "mesh": mesh_label(mesh),
                   "wall_s": time.perf_counter() - t0,
                   "errors": list(self._warm_errors)}
        self.tel.events.emit("warmup", buckets=summary["buckets"],
                             batch=batch, route=kind,
                             mesh=summary["mesh"],
                             wall_s=summary["wall_s"])
        return summary

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join a background warmup, if one is running."""
        with self._lock:
            t = self._warm_thread
        if t is not None:
            t.join(timeout)

    # --------------------------------------------------------- admission
    def warmed_buckets(self, kind: str = "dense",
                       mesh: str = MESH_NONE) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._warmed_buckets.get((kind, mesh), ())))

    def route_bucket(self, native: int, cfg: aco.ACOConfig,
                     kind: str = "dense", mesh: str = MESH_NONE) -> int:
        """Admission-time bucket choice: the native bucket when warmed (or
        when neighbour routing is unsupported for this config), else the
        nearest larger warmed bucket, else native (the engine's own path,
        exactly the behaviour without a cache)."""
        warmed = self.warmed_buckets(kind, mesh)
        if native in warmed:
            return native
        if not neighbour_supported(cfg):
            return native
        bigger = [b for b in warmed if b > native]
        return min(bigger) if bigger else native

    # ---------------------------------------------------------- hot path
    def call(self, fn, problem, states, budgets, cfg, max_iters, patience,
             since, mets, kind: str, ewt: str, donate: bool):
        """Dispatch one ``run_batch`` call: the warmed program of its
        signature (``jit_cache_hit``), the engine's own path ``fn``
        otherwise (``jit_cache_miss``).  A program that fails emits
        ``aot_dispatch_fallback`` and the call takes ``fn``."""
        key = self.signature(problem, states, budgets, cfg, max_iters,
                             patience, donate, kind, ewt)
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            try:
                out = prog.run(problem, states, budgets, max_iters,
                               patience, since, mets, donate)
                self._c_hit.inc()
                return out
            except Exception as e:            # noqa: BLE001 -- a failed
                # program must degrade to the engine's own path, not fail
                # the request; the event makes the fall visible
                self.tel.events.emit(
                    "aot_dispatch_fallback", bucket=key.n_pad,
                    batch=key.batch, error=f"{type(e).__name__}: {e}")
        self._c_miss.inc()
        self._note_miss(key)
        return fn(problem, states, budgets, cfg, max_iters, patience,
                  since, mets, kind=kind, ewt=ewt, donate=donate)

    def note_mesh_call(self, key: ProgramKey) -> None:
        """Hit/miss accounting for the sharded route (its dispatch stays
        with the placement layer)."""
        if key.n_pad in self.warmed_buckets(key.kind, key.mesh):
            self._c_hit.inc()
        else:
            self._c_miss.inc()
            self._note_miss(key)

    def _note_miss(self, key: ProgramKey) -> None:
        sig = (key.n_pad, key.batch, key.kind, key.ewt, key.mesh,
               key.max_iters, key.donate)
        with self._lock:
            if sig not in self._missed_keys and len(self._missed_keys) < 32:
                self._missed_keys.append(sig)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The reference's keys, plus ``signatures``: each warmed program's
        bucket, batch, kind, device, number of CUDA graphs, the active
        patterns they cover and their memory pool's bytes (``graphs`` 0 and
        ``eager`` true where the signature runs eagerly)."""
        with self._lock:
            buckets = {f"{kind}@{mesh}": sorted(bs)
                       for (kind, mesh), bs in self._warmed_buckets.items()}
            missed = [
                {"bucket": s[0], "batch": s[1], "kind": s[2], "ewt": s[3],
                 "mesh": s[4], "max_iters": s[5], "donate": s[6]}
                for s in self._missed_keys]
            progs = list(self._programs.items())
            errors = list(self._warm_errors)
        sigs = [{"bucket": k.n_pad, "batch": k.batch, "kind": k.kind,
                 "device": k.device, "max_iters": k.max_iters,
                 "donate": k.donate, "eager": not p.graphed,
                 "graphs": len(p.graphs),
                 "patterns": ["all" if f is None else
                              "".join("1" if a else "0" for a in f)
                              for f in list(p.graphs)],
                 "pool_bytes": p.pool_bytes}
                for k, p in progs]
        return {
            "programs": len(progs),
            "warmed_buckets": buckets,
            "hits": self._c_hit.value,
            "misses": self._c_miss.value,
            "warmup_compile_s": self._c_warm_s.value,
            "warmup_programs": self._c_warm_programs.value,
            "missed_signatures": missed,
            "warm_errors": errors,
            "signatures": sigs,
        }
