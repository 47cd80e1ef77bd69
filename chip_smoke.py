#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

``python3 chip_smoke.py --solo ROOT [ROOT ...]`` instead runs the solo
paths' timing phases ([main], [profile], [split], [sparse-split]) of each
checkout's own chip_smoke.py, one process per ROOT in the order given: an
A/B of two commits on one card reads parent, change, change, parent.

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. device  -- requires CUDA; prints ``nvidia-smi`` name and power limit;
2. build   -- builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels -- each kernel against its plain PyTorch version at the main
   path's shapes (n = m = 1002, the paper's pr1002, and n = m = 2392, the
   paper's pr2392), an odd n and a masked n_actual, all three selection
   modes, a float32 and a quantised (int8, bf16) tau; the 2-opt reduction
   in both move rules on operands from real tours at m = n = 1002, k = 30,
   unmasked and masked; times each (CUDA events) beside its plain version
   and its bound;
   K2 from tours (the colony step's update) bitwise against the CPU plain
   composition and across two launches, AS (m = n) and MMAS (m = 1), rho
   0.5 and 0.1, at every n above; timed beside the edge-stream K2, the
   ``mul`` + ``index_add_`` yardstick and that yardstick with the stream
   built from tours.
   The sparse route's K7 (fp32, int8, bf16 pages) in all three modes at
   (m, K) = (64, 20), n = 1002 and 2392, and (2392, 36), on pages gathered
   from a real sparse problem with overflow columns, fully visited pages
   and ids < 0; times each at (64, 20), n = 2392.  The walk kernel at the
   route's shapes (n = 2392, k = 16 + 4, m = 64) bitwise against the plain
   walk on the card over fp32/int8/bf16 pages, the three modes, packed and
   counter draws (whole walks, and a walk's last 200 steps), a padded
   instance and Partial-ACO windows; timed per
   launch beside the plain walk and the per-step loop it replaced.
   The dense walk kernel (``fused_walk``: every step of the dense fused
   construction in one launch, fp32, int8 and bf16 tau) bitwise against
   the plain walk on the card: whole walks at n = m = 1002 in all three
   modes and both draws, the same grid over the last 200 steps of a walk
   at n = m = 2392 and one whole walk there, n = 997 and n_actual = 901;
   timed per launch at 1002 and 2392 beside the per-step route it replaced
   (the one-step kernel over the plain draw, once a step) and the plain
   walk, with its bound: bytes, float32 work and the threefry hashes'
   integer work at the INT32 rate derived from the card's clock;
   K3 and K4 over a stack at bucket 1024, B = 4 (n_actual 1024, 613,
   1002, 801, slot 1 inactive) bitwise their single launches and plain
   versions, and K5 over a B = 4 local-search round's folded (4096, 30720)
   rows bitwise one launch per slot; each stack's device time beside four
   single launches;
4. small   -- the one-rounding multiply-add (``torch.addcmul``) and the
   per-step draw on the card against the CPU, bitwise; small colonies on
   the card's kernel route (plain MMAS and AS, MMAS + 2-opt/Or-opt, MMAS
   over a stochastic int8 store; sparse MMAS, sparse Partial-ACO and
   sparse MMAS over int8 pages with k = 4 + 4 overflow slots, where
   adoption, eviction and the page-fault fallback occur) against the same
   colonies on the CPU (plain versions), and no worse than the
   nearest-neighbour tour;
5. main    -- ``aco.run`` at n = m = 1002: AS, MMAS and ACS on the fused
   kernel route (one ``fused_walk`` launch an iteration, the one-step
   ``fused_select`` never), AS on ``construction="pallas"``, MMAS + 2-opt, ACS +
   2-opt/Or-opt (first improvement, every 2nd iteration), MMAS over an
   int8 store and AS over a bf16 store; three AS iterations at
   n = m = 2392 (the paper's pr2392).  Launch counts are zeroed before each run and
   checked after it (2-opt reductions: one per local-search round that
   ``localsearch.improve`` reports).  MMAS and MMAS + 2-opt run until the
   best tour is no worse than the nearest-neighbour tour, and MMAS +
   2-opt is no worse than plain MMAS after the first iteration; the
   shorter runs are held to 1.2 x that tour;
   sparse    -- ``aco.run(sparse=True)`` at n = 2392 (k = 16 + 4, m = 64),
   10 iterations each: MMAS data-parallel over fp32, int8 and bf16 pages,
   MMAS Partial-ACO (window 64, best never rises, no worse than the NN
   tour), AS and ACS, held to 1.2 x the NN tour; each run launches the
   walk kernel once per iteration and the one-step K7 never;
   batched   -- the batched engine (``solver.engine.solve_instances`` /
   ``run_batch``) on the kernel route: MMAS over
   ``tsp.random_instance(n, seed=n)`` for n = 613, 801, 1002, 1024 in one
   bucket of 1024 (m = 1024 ants a slot), seeds 0-3, budgets (3, 5, 4, 5):
   each slot bitwise its solo run in the same bucket (best_len, best_tour,
   iteration, key, tau), the n = 1024 slot bitwise ``aco.run`` of the
   unpadded instance, iterations equal to the budgets, ``fused_walk`` and
   ``pheromone_update_tours`` launched once per engine iteration (5),
   serving one slot-launch per slot-iteration (17), and the one-step
   kernels never, every real prefix a permutation with the phantom tail in
   index order, each best within 1.2 x its NN tour; the instance axis at
   the bucket's shapes: one walk launch over the four slots' stack (one
   slot inactive) bitwise single launches in fp32/int8/bf16 x three modes
   and the plain walks, one update launch (m = 1024 and 1) bitwise single
   launches and the plain updates, the stack's walk timed beside four
   single launches; MMAS +
   2-opt over an int8 store (two slots, two iterations: one walk launch
   per engine iteration, ``two_opt_best`` once per round of the stack);
   sparse MMAS (k = 16 + 4,
   m = 64) on n = 1500 and 2000 in bucket 2048, 10 iterations, batched ==
   solo, 10 ``sparse_walk`` launches serving 20 slot-iterations; the
   sparse walk's instance axis at bucket 2048, B = 4 (n = 2048, 1500,
   2000, 1800, the second slot inactive): one launch over the stack
   bitwise four single launches in fp32/int8/bf16 x three modes x packed
   and counter draws (whole walks), and the plain walks (each walk's last
   50 steps over the same grid, and one padded slot's whole walk), timed
   beside four single launches; AS on ``construction="pallas"`` over the
   bucket of 1024 (two iterations: one ``choice_info`` launch and 1023
   ``tour_select`` launches per engine iteration, every slot bitwise its
   solo run); MMAS + 2-opt fp32 with ``ls_every=2`` over the four slots
   started at iterations 0-3 (one ``two_opt_best`` launch per round of the
   stack, every slot bitwise its solo run from the same state) and the
   peak memory of one 2-opt and one Or-opt round over the stack and over
   one slot; one MMAS + 2-opt (profiled) and one AS ``pallas`` engine
   iteration at B = 4 beside four solo ones (wall, local-search share,
   peak memory, busy, idle share);
   sparse AS in the same bucket (one
   iteration: a solo run repeated, and batched against solo, tau at rtol
   1e-5 / atol 1e-7 where the card's atomic deposit sums differ); small
   buckets (n <= 64) card == CPU
   for AS, MMAS + 2-opt, int8, sparse, ``construction="pallas"`` and
   ``patience=2``, and a run chunked in 2s == one long call.  Prints the
   batched ``run_batch`` time per engine iteration beside the sum of its
   slots' solo runs, and ``torch.profiler`` profiles of one engine
   iteration at B = 4, bucket 1024, and of one sparse engine iteration at
   B = 4, bucket 2048 (beside four solo iterations);
   service   -- ``SolverService`` (MMAS, kernel route, ``metrics=True``,
   ``max_batch=4``, ``patience=3``, 6 iterations): six requests (n = 613,
   801, 1002, 1002, 1500, 2000) from two tenants, one job in bucket 1024
   and one in 2048, drained plain, with checkpoints every 2 iterations
   and one crash injected after a chunk, and with metrics off: the three
   agree bitwise (best_len, best_tour, iterations), the first two in
   their metrics rows too; the trace and the event log validate
   (``obs.validate``).  Prints instances/s, mean and max latency,
   ``solve_s`` per job and the time of a checkpoint save;
   streaming -- ``StreamingSolverService`` (MMAS, kernel route,
   ``metrics=True``, ``max_batch=4``, ``chunk=2``, ``max_waiting=6``):
   ``make_poisson_trace(12, rate=20, n 520-1024, budgets (4, 4, 4, 12),
   tenants a/b)`` replayed with two more requests (n = 1500, 2000) in
   bucket 2048 and one (n = 900, 200 iterations) whose 0.5 s deadline
   lapses while it runs: every completed result bitwise its solo
   ``run_batch`` on the card and the drain service's result, the expired
   one a valid partial tour with fewer iterations than its budget, walk
   and update launches equal to the pools' engine iterations and
   slot-launches to the slot-iterations, trace and events valid.  Prints
   instances/s, latency mean / p95 / max and mean occupancy beside
   ``SolverService`` draining the same requests;
   cli       -- the serving CLI, ``python -m repro_torch.launch.solve_serve``
   in subprocesses on the card: a dense MMAS drain (``--use-pallas
   --metrics``, six requests of 500-1002 cities, buckets 512 / 1024, m =
   the bucket, six iterations, ``--max-batch 4``), the same drain with
   ``--local-search 2opt`` (one ``two_opt_best`` launch per round of each
   job's stack), the same requests streamed (``--stream --arrival-rate
   20 --chunk 2``), and sparse MMAS
   drains (``--sparse --ants 64 --sparse-k 16 --sparse-overflow 4``, six
   requests of 1500-2392 cities, buckets 2048 / 4096, ten iterations) over
   fp32 and int8 pages: each exits 0 with every request completed, its
   results equal to an in-process ``SolverService`` over the same
   requests (whose launches are counted); the dense drain with
   ``--shard`` (a mesh of the card's one position) equal to the unsharded
   drain per request; ``--sparse --shard`` and ``--sparse --stream`` exit
   2 with one line on stderr.  Prints instances/s and mean / max latency
   from each report;
   mesh      -- ROADMAP item 14 over meshes whose positions repeat the
   card: four MMAS islands at n = m = 1002 (two rounds of two iterations,
   plain and with 2-opt polish of the immigrants; one ``fused_walk`` and
   one ``pheromone_update_tours`` launch per island iteration) and one
   round timed beside four solo colonies, the exchange alone; four AS +
   2-opt islands at n = 100 card == CPU; the city-sharded colony at
   n = m = 1002 over S = 3 column slabs (two iterations) and over a
   (2, 3) mesh with the ants split over ``data`` (one), the edge-stream
   ``pheromone_update`` launched once per slab and iteration, one
   iteration beside S = 1; the edge-stream kernel on a (1002, 334) slab
   against its plain version, timed with its bound and the library
   call; the sharded colony at n = 96, S = 4 card == CPU; ``run_batch``
   over four positions on the [batched] bucket bitwise the unsharded run
   per slot and timed beside it; ``SolverService`` and
   ``StreamingSolverService`` over four positions bitwise their
   unsharded runs;
6. profile -- device busy time and idle share of one AS iteration at
   n = 1002, and the kernels that take most of it; the split of one MMAS
   + 2-opt iteration over an int8 store into construction, local search
   and update + requantise; the split of one sparse MMAS int8 iteration
   at n = 2392 and the profile of a sparse fp32 one;
7. one JSON line listing every kernel, then the card's ``nvidia-smi``
   line, then the last line ``{"ok": true, "device": {...}}``.  The
   one-step K1/K6 and the one-step K7 keep the reference kernels' own
   signatures and are checked and timed, but no path launches them any
   more: their entries report 0 launches and name the kernel that took
   their place (``superseded_by``).  The edge-stream K2 is launched by the
   city-sharded colony ([mesh]); its entry holds the (1002, 334) slab's
   numbers.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# INT32 is not on the data sheet: 64 INT32 lanes per SM x 132 SMs x the
# card's maximum SM clock (nvidia-smi clocks.max.sm), set by phase_device.
INT32_LANES = 64 * 132
INT32_OPS_PER_S = None
# Integer operations of one threefry-2x32 hash as the walk kernels run it:
# 60 in the 20 rounds (add, rotate, xor), 12 in the key injections and the
# counter set-up, 8 in the counter and the bits-to-float conversion.
HASH_OPS = 80

KERNELS = {  # name -> (CUDA source, the Pallas kernel's pallas_call line)
    "fused_select": ("src/repro_torch/kernels/csrc/fused_select.cu",
                     "src/repro/kernels/fused_select.py:176"),
    "pheromone_update": ("src/repro_torch/kernels/csrc/pheromone_update.cu",
                         "src/repro/kernels/pheromone_update.py:94"),
    "choice_info": ("src/repro_torch/kernels/csrc/choice_info.cu",
                    "src/repro/kernels/choice_info.py:64"),
    "tour_select": ("src/repro_torch/kernels/csrc/tour_select.cu",
                    "src/repro/kernels/tour_select.py:103"),
    # the quantised payload of fused_select, one entry per payload
    "fused_select_quant_int8": ("src/repro_torch/kernels/csrc/fused_select.cu",
                                "src/repro/kernels/fused_select.py:176"),
    "fused_select_quant_bf16": ("src/repro_torch/kernels/csrc/fused_select.cu",
                                "src/repro/kernels/fused_select.py:176"),
    "two_opt_best": ("src/repro_torch/kernels/csrc/two_opt.cu",
                     "src/repro/kernels/two_opt.py:119"),
    # K7 and its quantised page payload (K6's sparse half), one entry per
    # payload
    "sparse_select": ("src/repro_torch/kernels/csrc/sparse_select.cu",
                      "src/repro/kernels/sparse_select.py:159"),
    "sparse_select_quant_int8": (
        "src/repro_torch/kernels/csrc/sparse_select.cu",
        "src/repro/kernels/sparse_select.py:159"),
    "sparse_select_quant_bf16": (
        "src/repro_torch/kernels/csrc/sparse_select.cu",
        "src/repro/kernels/sparse_select.py:159"),
    # K2 driven by the deposit tours: the colony step's update
    "pheromone_update_tours": (
        "src/repro_torch/kernels/csrc/pheromone_update.cu",
        "src/repro/kernels/pheromone_update.py:94"),
    # the sparse route's whole walk (K7 and its payloads), one entry per
    # payload
    "sparse_walk": ("src/repro_torch/kernels/csrc/sparse_select.cu",
                    "src/repro/kernels/sparse_select.py:159"),
    "sparse_walk_quant_int8": ("src/repro_torch/kernels/csrc/sparse_select.cu",
                               "src/repro/kernels/sparse_select.py:159"),
    "sparse_walk_quant_bf16": ("src/repro_torch/kernels/csrc/sparse_select.cu",
                               "src/repro/kernels/sparse_select.py:159"),
    # the dense route's whole walk (K1 and its payloads, K6), one entry per
    # payload
    "fused_walk": ("src/repro_torch/kernels/csrc/fused_select.cu",
                   "src/repro/kernels/fused_select.py:176"),
    "fused_walk_quant_int8": ("src/repro_torch/kernels/csrc/fused_select.cu",
                              "src/repro/kernels/fused_select.py:176"),
    "fused_walk_quant_bf16": ("src/repro_torch/kernels/csrc/fused_select.cu",
                              "src/repro/kernels/fused_select.py:176"),
}
# Launchers that keep the reference kernel's own signature and are checked
# and timed here, but that no path of the port launches any more: the
# kernel that took their place on the path.
SUPERSEDED = {
    "fused_select": "fused_walk",
    "fused_select_quant_int8": "fused_walk_quant_int8",
    "fused_select_quant_bf16": "fused_walk_quant_bf16",
    "sparse_select": "sparse_walk",
    "sparse_select_quant_int8": "sparse_walk_quant_int8",
    "sparse_select_quant_bf16": "sparse_walk_quant_bf16",
}
QUANT = ("int8", "bf16")
MODES = ("iroulette", "gumbel", "greedy")
# MMAS at n = 1002 runs in chunks of this many iterations until its best
# tour is no worse than the nearest-neighbour tour, and fails at the cap.
MMAS_CHUNK, MMAS_CAP = 5, 40
# The sparse route at its users' size (benchmarks/sparse_scale.py): the
# size of pr2392, 64 ants, 16 candidates + 4 overflow slots per city.
SPARSE_N, SPARSE_M, SPARSE_K = 2392, 64, 16
# The walk kernels' grids check each case's last this many steps against
# the plain walk (a whole plain walk at n = 2392 takes 9-17 s).
WALK_WINDOW = 200


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 20, trials: int = 5, warmup: int = 3) -> float:
    """Median over trials of the mean time of ``reps`` calls (CUDA events),
    after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 10, tries: int = 3):
    """Device time per call (ms): the sum of the kernels' own durations
    that ``torch.profiler`` records over ``reps`` calls, or None where
    ``tries`` profiles in a row record no device time (a profile now and
    then drops the kernels a ``ctypes`` call launched)."""
    for _ in range(tries):
        us = sum(device_split(fn, reps).values())
        if us > 0:
            return us / 1e3
    return None


def device_split(fn, reps: int = 10) -> dict:
    """Device time per call (us) of each kernel that ``fn`` launches, by
    name, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / reps
    return out


def bound(nbytes: float, ops: float, int_ops: float = 0.0
          ) -> tuple[float, str]:
    """Least time for the work on the card (ms) and what bounds it: bytes
    over the memory rate, or the float32 operations over the fp32 rate and
    the integer ones over the INT32 rate, whichever is longer (the two
    pipes issue side by side)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    global INT32_OPS_PER_S
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs a GPU")
    smi = _smi("name,power.limit")
    clock = _smi("clocks.max.sm")
    mhz = float(clock.split()[0])
    INT32_OPS_PER_S = INT32_LANES * mhz * 1e6
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] INT32 rate {INT32_OPS_PER_S:.4g}/s = 64 lanes x 132 SMs x "
        f"clocks.max.sm {clock} (not on the data sheet); fp32 "
        f"{FP32_OPS_PER_S:.3g}/s, HBM {HBM_BYTES_PER_S:.3g} B/s (data sheet)")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    path, secs = _build.build()
    _build.load()
    log(f"[build] {path.name} built in {secs:.1f} s from "
        f"{len(_build.sources())} sources ({path.parent})")
    ptxas = (path.parent / "build.log").read_text().splitlines()
    for ln in ptxas:
        if "registers" in ln or ln.startswith("== "):
            log("[build]   " + ln.strip())


def _selection_inputs(torch, gen, m, n, dev):
    visited = torch.rand((m, n), generator=gen, device=dev) < 0.5
    rand = torch.rand((m, n), generator=gen, device=dev) * (1 - 1e-6) + 1e-6
    cur = torch.randint(0, n, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    return visited, rand, cur


def phase_kernels(results: dict) -> None:
    """Each kernel against its plain version, then its time and bound."""
    import torch
    from repro_torch.core import (aco, localsearch, quant, sampling,
                                  strategies, tsp)
    from repro_torch.kernels import (choice_info as ci, fused_select as fs,
                                     pheromone_update as pu, tour_select as ts,
                                     two_opt as topt)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {k: 0.0 for k in KERNELS}  # stays 0 where the check is bitwise

    def problem(n):
        inst = tsp.random_instance(n, seed=n)
        prob = aco.make_problem(inst, 10, dev)
        tau = torch.rand((n, n), generator=gen, device=dev) * 1e-3 + 1e-4
        return prob, tau

    # n, n_actual: the main path's two sizes, an odd n, a masked n
    cases = [(1002, None), (2392, None), (997, None), (1002, 901)]
    for n, n_act in cases:
        prob, tau = problem(n)
        m = n
        visited, rand, cur = _selection_inputs(torch, gen, m, n, dev)
        for alpha, beta in ((1.0, 2.0), (2.0, 3.0)):
            got = ci.choice_info(tau, prob.eta, alpha, beta, n_act)
            want = ci.choice_info_plain(tau, prob.eta, alpha, beta, n_act)
            if not torch.equal(got, want):
                raise AssertionError(f"choice_info != plain at n={n} "
                                     f"n_actual={n_act} a={alpha} b={beta}")
            err["choice_info"] = max(err["choice_info"],
                                     float((got - want).abs().max()))
        rows = ci.choice_info_plain(tau, prob.eta, 1.0, 2.0)[cur.long()]
        for mode in MODES:
            got = ts.tour_select(rows, visited, rand, mode, n_act)
            want = ts.tour_select_plain(rows, visited, rand, mode, n_act)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"tour_select != plain ({bad} ants) at "
                                     f"n={n} n_actual={n_act} mode={mode}")
            got = fs.fused_select(tau, prob.eta, cur, visited, rand, 1.0, 2.0,
                                  n_act, mode)
            want = fs.fused_select_plain(tau, prob.eta, cur, visited, rand,
                                         1.0, 2.0, n_act, mode)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"fused_select != plain ({bad} ants) at "
                                     f"n={n} n_actual={n_act} mode={mode}")
        # the quantised payloads: a stochastically rounded store of tau
        for dtype in QUANT:
            qt = quant.quantise(tau, dtype, key=sampling.prng_key(n, dev))
            scale = qt.scale if dtype == "int8" else None
            for mode in MODES:
                got = fs.fused_select_quant(qt.q, scale, prob.eta, cur,
                                            visited, rand, 1.0, 2.0, n_act,
                                            mode)
                want = fs.fused_select_quant_plain(qt.q, scale, prob.eta, cur,
                                                   visited, rand, 1.0, 2.0,
                                                   n_act, mode)
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"fused_select_quant[{dtype}] != plain ({bad} ants) "
                        f"at n={n} n_actual={n_act} mode={mode}")
        # pheromone_update: one tour (every cell <= 1 deposit) is bitwise;
        # m tours (AS) sum in atomic order, held to rtol 1e-5 / atol 1e-7.
        for n_ants, exact in ((1, True), (m, False)):
            tours = torch.stack([torch.randperm(n, generator=gen, device=dev)
                                 for _ in range(n_ants)]).to(torch.int32)
            frm = tours.reshape(-1)
            to = torch.roll(tours, -1, dims=-1).reshape(-1)
            f2, t2 = torch.cat([frm, to]), torch.cat([to, frm])
            w = torch.rand(n_ants, generator=gen, device=dev) * 1e-3
            w2 = w[:, None].expand(n_ants, n).reshape(-1).repeat(2)
            for rho in (0.5, 0.1):
                got = pu.pheromone_update(tau, f2, t2, w2, rho)
                want = pu.pheromone_update_plain(tau, f2, t2, w2, rho)
                if exact and not torch.equal(got, want):
                    raise AssertionError(f"pheromone_update != plain (single "
                                         f"deposit) n={n} rho={rho}")
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
                err["pheromone_update"] = max(
                    err["pheromone_update"], float((got - want).abs().max()))
        # rectangular column shard, `to` shifted into the shard's frame
        half = n // 2
        got = pu.pheromone_update(tau[:, :half].contiguous(), f2, t2 - half,
                                  w2, 0.1)
        want = pu.pheromone_update_plain(tau[:, :half].contiguous(), f2,
                                         t2 - half, w2, 0.1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        # K2 from tours (the colony step's update): AS with m = n ants and
        # MMAS with one, tours as construction emits them (the phantom tail
        # in index order when n_actual is set), bitwise against the CPU
        # plain composition, and the same from launch to launch.
        real = n if n_act is None else n_act
        for n_ants in (m, 1):
            tours = torch.stack([torch.cat([
                torch.randperm(real, generator=gen, device=dev),
                torch.arange(real, n, device=dev)]) for _ in range(n_ants)]
            ).to(torch.int32)
            w = torch.rand(n_ants, generator=gen, device=dev) * 1e-3
            for rho in (0.5, 0.1):
                got = pu.pheromone_update_tours(tau, tours, w, rho, n_act)
                again = pu.pheromone_update_tours(tau, tours, w, rho, n_act)
                want = pu.pheromone_update_tours_plain(
                    tau.cpu(), tours.cpu(), w.cpu(), rho, n_act)
                if not torch.equal(got.cpu(), want):
                    bad = int((got.cpu() != want).sum())
                    raise AssertionError(
                        f"pheromone_update_tours != CPU plain in {bad} cells "
                        f"at n={n} n_actual={n_act} ants={n_ants} rho={rho}")
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"pheromone_update_tours differs between two launches "
                        f"at n={n} n_actual={n_act} ants={n_ants} rho={rho}")
        log(f"[kernels] n={n} n_actual={n_act}: choice_info, tour_select, "
            f"fused_select, fused_select_quant (int8, bf16) bitwise in "
            f"{', '.join(MODES)}; pheromone_update bitwise (1 ant), rtol "
            f"1e-5/atol 1e-7 ({m} ants); pheromone_update_tours bitwise "
            f"against the CPU and across launches ({m} ants and 1, rho 0.5 "
            f"and 0.1)")

    # two_opt_best on the main path's operands: m = n = 1002, k = 30, from
    # tours the colony constructs (kernel route), unmasked and masked.
    two_opt_operands = None
    for n_act in (None, 901):
        if n_act is None:
            inst = tsp.random_instance(1002, seed=7)
        else:
            inst = tsp.pad_instance(tsp.random_instance(n_act, seed=7), 1002)
        prob = aco.make_problem(inst, 30, dev)._replace(n_actual=n_act)
        st = aco.init_colony(inst, aco.ACOConfig(), device=dev)
        res = strategies.construct_tours(
            sampling.prng_key(3, dev), prob.dist, None, 1002, method="fused",
            tau=st.tau, eta=prob.eta, n_actual=n_act)
        a1, a2, r1, r2, valid, _ = localsearch._two_opt_operands(
            prob.dist, prob.nn, res.tours, n_act)
        flat = [x.reshape(1002, -1) for x in (a1, a2, r1, r2, valid)]
        for mode in ("best", "first"):
            got = topt.two_opt_best(*flat, thr=1e-3, mode=mode)
            want = topt.two_opt_best_plain(*flat, thr=1e-3, mode=mode)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                bad = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
                raise AssertionError(f"two_opt_best != plain ({bad} ants) "
                                     f"n_actual={n_act} mode={mode}")
        if n_act is None:
            two_opt_operands = flat
        log(f"[kernels] two_opt_best m=n=1002 k=30 (M={flat[0].shape[1]}) "
            f"n_actual={n_act}: bitwise in best and first")

    # Timing at the main path's shapes: n = m = 1002, iroulette.
    n = m = 1002
    prob, tau = problem(n)
    visited, rand, cur = _selection_inputs(torch, gen, m, n, dev)
    rows = ci.choice_info_plain(tau, prob.eta, 1.0, 2.0)[cur.long()]
    tours = torch.stack([torch.randperm(n, generator=gen, device=dev)
                         for _ in range(m)]).to(torch.int32)
    frm = tours.reshape(-1)
    to = torch.roll(tours, -1, dims=-1).reshape(-1)
    f2, t2 = torch.cat([frm, to]), torch.cat([to, frm])
    w2 = (torch.rand(m, generator=gen, device=dev) * 1e-3)[:, None] \
        .expand(m, n).reshape(-1).repeat(2)
    e = f2.numel()
    distinct_rows = int(torch.unique(cur).numel())
    flat = f2.long() * n + t2.long()

    def evap_index_add():
        out = tau * 0.9
        return out.view(-1).index_add_(0, flat, w2)

    # the same deposit from tours: w per ant, the stream the yardstick
    # reads built from the tours first (what the kernel saves)
    w_ant = w2[::n][:m].contiguous()

    def stream_then_index_add():
        f, t = torch.roll(tours, -1, dims=-1), tours
        fl = torch.cat([t.reshape(-1).long() * n + f.reshape(-1).long(),
                        f.reshape(-1).long() * n + t.reshape(-1).long()])
        wr = w_ant[:, None].expand(m, n).reshape(-1).repeat(2)
        return (tau * 0.9).view(-1).index_add_(0, fl, wr)

    timing = {
        "fused_select": (
            lambda: fs.fused_select(tau, prob.eta, cur, visited, rand),
            lambda: fs.fused_select_plain(tau, prob.eta, cur, visited, rand),
            None,
            distinct_rows * n * 8 + m * n * 5 + m * 8, m * n * 6),
        "pheromone_update": (
            lambda: pu.pheromone_update(tau, f2, t2, w2, 0.5),
            lambda: pu.pheromone_update_plain(tau, f2, t2, w2, 0.5),
            evap_index_add,
            n * n * 8 + e * 12, n * n + e),
        "pheromone_update_tours": (
            lambda: pu.pheromone_update_tours(tau, tours, w_ant, 0.5),
            lambda: pu.pheromone_update_tours_plain(tau, tours, w_ant, 0.5),
            evap_index_add,
            n * n * 8 + m * n * 4 + m * 4, n * n + 2 * m * n),
        "choice_info": (
            lambda: ci.choice_info(tau, prob.eta, 1.0, 2.0),
            lambda: ci.choice_info_plain(tau, prob.eta, 1.0, 2.0),
            None,
            n * n * 12, n * n * 2),
        "tour_select": (
            lambda: ts.tour_select(rows, visited, rand),
            lambda: ts.tour_select_plain(rows, visited, rand),
            None,
            m * n * 9 + m * 4, m * n * 3),
    }
    # K6: the same step over a quantised store; tau reads 1 (int8, plus one
    # scale per row) or 2 (bf16) bytes per gathered cell instead of 4.
    for dtype, tau_bytes, extra_ops in (("int8", 1, 1), ("bf16", 2, 0)):
        qt = quant.quantise(tau, dtype, key=sampling.prng_key(1, dev))
        scale = qt.scale if dtype == "int8" else None
        timing[f"fused_select_quant_{dtype}"] = (
            lambda q=qt.q, s=scale: fs.fused_select_quant(
                q, s, prob.eta, cur, visited, rand),
            lambda q=qt.q, s=scale: fs.fused_select_quant_plain(
                q, s, prob.eta, cur, visited, rand),
            None,
            distinct_rows * n * (tau_bytes + 4) + m * n * 5 + m * 8
            + (distinct_rows * 4 if dtype == "int8" else 0),
            m * n * (6 + extra_ops))
    # K5: four float32 operands and one mask byte per move, best mode.
    mt = two_opt_operands[0].shape[1]
    timing["two_opt_best"] = (
        lambda: topt.two_opt_best(*two_opt_operands, thr=1e-3, mode="best"),
        lambda: topt.two_opt_best_plain(*two_opt_operands, thr=1e-3,
                                      mode="best"),
        None,
        m * mt * 17 + m * 8, m * mt * 4)
    # "ms" is the device time of the call's kernels (torch.profiler); the
    # per-call time between CUDA events, which includes the host's launch
    # cost when that is longer, is printed beside it.
    def both(fn, reps):
        wall = cuda_ms(fn, reps=reps)
        dev_ms = device_ms(fn)
        return (wall if dev_ms is None else dev_ms), wall

    for name, (kern, plain, lib_fn, nbytes, ops) in timing.items():
        ms, wall = both(kern, 20)
        plain_ms, plain_wall = both(plain, 5)
        lib_ms, lib_wall = both(lib_fn, 5) if lib_fn else (None, None)
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {"max_abs_err": err[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms}
        log(f"[kernels] {name} n=m=1002{' k=30' if name == 'two_opt_best' else ''}: device {ms * 1e3:.2f} us, per call "
            f"{wall * 1e3:.1f} us | plain device {plain_ms * 1e3:.1f} us, per "
            f"call {plain_wall * 1e3:.1f} us"
            + (f" | library device {lib_ms * 1e3:.1f} us, per call "
               f"{lib_wall * 1e3:.1f} us" if lib_fn else "")
            + f" | bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({nbytes / 1e6:.1f} MB)")

    # K2 from tours and its yardstick on the tours AS constructs at
    # n = m = 1002 (ants share edges, so cells take several deposits) and
    # on converged tours (every ant on one tour: each cell of it takes m)
    from repro_torch.core import pheromone as ph
    built = strategies.construct_tours(
        sampling.prng_key(4, dev), prob.dist, None, n, method="fused",
        tau=tau, eta=prob.eta).tours
    for label, t in (("constructed", built),
                     ("converged", tours[:1].expand(m, n).contiguous())):
        f, t2_ = ph.tour_edges(t)
        fl = torch.cat([f.reshape(-1).long() * n + t2_.reshape(-1).long(),
                        t2_.reshape(-1).long() * n + f.reshape(-1).long()])
        wr = w_ant[:, None].expand(m, n).reshape(-1).repeat(2)
        k_ms, _ = both(lambda: pu.pheromone_update_tours(tau, t, w_ant, 0.5),
                       10)
        y_ms, _ = both(lambda: (tau * 0.9).view(-1).index_add_(0, fl, wr), 5)
        log(f"[kernels] pheromone_update_tours n=m=1002 on {label} tours: "
            f"device {k_ms * 1e3:.2f} us | yardstick device "
            f"{y_ms * 1e3:.2f} us")

    # K2's yardstick with the stream built from tours first, and K2 from
    # tours at n = m = 2392 (AS)
    ys_ms, ys_wall = both(stream_then_index_add, 5)
    log(f"[kernels] pheromone_update yardstick with the edge stream built "
        f"from tours, n=m=1002: device {ys_ms * 1e3:.1f} us, per call "
        f"{ys_wall * 1e3:.1f} us")
    n2 = m2 = 2392
    tau2 = torch.rand((n2, n2), generator=gen, device=dev) * 1e-3
    tours2 = torch.stack([torch.randperm(n2, generator=gen, device=dev)
                          for _ in range(m2)]).to(torch.int32)
    w_2 = torch.rand(m2, generator=gen, device=dev) * 1e-3
    k2_ms, k2_wall = both(
        lambda: pu.pheromone_update_tours(tau2, tours2, w_2, 0.5), 10)
    b2_ms, _ = bound(n2 * n2 * 8 + m2 * n2 * 4 + m2 * 4, 0)
    log(f"[kernels] pheromone_update_tours n=m=2392: device "
        f"{k2_ms * 1e3:.2f} us, per call {k2_wall * 1e3:.1f} us | bound "
        f"{b2_ms * 1e3:.2f} us by bytes")
    for label, fn in (
            ("n=m=1002", lambda: pu.pheromone_update_tours(tau, tours, w_ant,
                                                           0.5)),
            ("n=m=2392", lambda: pu.pheromone_update_tours(tau2, tours2, w_2,
                                                           0.5))):
        parts = []
        for name, us in device_split(fn).items():
            kernel = re.findall(r"(\w+_kernel)", name)
            parts.append(f"{kernel[0] if kernel else name[:40]} {us:.2f} us")
        log(f"[kernels] pheromone_update_tours {label} by pass: "
            + ", ".join(parts))

    # The per-step draw (plain PyTorch, the reference's jax.random outside
    # any kernel) that feeds fused_select / tour_select on the main path.
    key = sampling.prng_key(0, dev)
    draw = lambda: strategies._draw_step_uniform(key, (m, n), "packed")  # noqa: E731
    d_ms, d_wall = both(draw, 5)
    log(f"[kernels] per-step draw U(1e-6, 1) at (1002, 1002), plain: device "
        f"{d_ms * 1e3:.1f} us, per call {d_wall * 1e3:.1f} us")
    _stacked_selection_kernels()


# K3 and K4 over a stack: the [batched] bucket (m = 1024 ants a slot), its
# slot 1 inactive in the checks; every slot active in the timings.
STACK_NS, STACK_PAD = (1024, 613, 1002, 801), 1024
STACK_ACTIVE = (True, False, True, True)


def _stacked_selection_kernels() -> None:
    """The instance axis of K3 and K4 at bucket 1024, B = 4 (n_actual
    1024, 613, 1002, 801, slot 1 inactive): one launch over the stack
    bitwise its single launches and the plain version; K5 at a B = 4
    local-search round's folded (B m, M) shape bitwise one launch per slot
    and the plain reduction.  Then each stack's device time (every slot
    active) beside four single launches."""
    import torch
    from repro_torch.core import aco, localsearch, tsp
    from repro_torch.kernels import (choice_info as ci, tour_select as ts,
                                     two_opt as topt)
    from repro_torch.solver import batch
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    nb, pad, act, ns = len(STACK_NS), STACK_PAD, STACK_ACTIVE, STACK_NS
    bt = batch.make_batch([tsp.random_instance(n, seed=n) for n in ns], pad,
                          30, device=dev)
    eta, na = bt.problem.eta, aco.slot_n_actual(bt.problem, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    tau = torch.rand((nb, pad, pad), generator=gen, device=dev) * 1e-3 + 1e-4
    for alpha, beta in ((1.0, 2.0), (2.0, 3.0)):
        got = ci.choice_info(tau, eta, alpha, beta, na, act)
        want = ci.choice_info_plain(tau, eta, alpha, beta, na, act)
        for i in range(nb):
            if act[i] and not (torch.equal(got[i], want[i]) and torch.equal(
                    got[i], ci.choice_info(tau[i], eta[i], alpha, beta,
                                           ns[i]))):
                raise AssertionError(f"choice_info stack slot {i} != its "
                                     f"single launch / plain (a={alpha})")
    m = pad
    choice = ci.choice_info_plain(tau, eta, 1.0, 2.0, na)
    cur = torch.stack([torch.randint(0, n, (m,), generator=gen, device=dev,
                                     dtype=torch.int32) for n in ns])
    rows = choice[torch.arange(nb, device=dev)[:, None], cur.long()]
    visited = torch.rand((nb, m, pad), generator=gen, device=dev) < 0.5
    rand = torch.rand((nb, m, pad), generator=gen, device=dev) \
        * (1 - 1e-6) + 1e-6
    for mode in MODES:
        got = ts.tour_select(rows, visited, rand, mode, na, act)
        want = ts.tour_select_plain(rows, visited, rand, mode, na, act)
        if not torch.equal(got, want):
            raise AssertionError(f"tour_select stack != plain ({mode})")
        for i in range(nb):
            if act[i] and not torch.equal(got[i], ts.tour_select(
                    rows[i], visited[i], rand[i], mode, ns[i])):
                raise AssertionError(f"tour_select stack slot {i} != its "
                                     f"single launch ({mode})")
    # K5: one round's operands over real tours (phantom tails in order)
    tours = torch.stack([torch.stack([torch.cat([
        torch.randperm(n, generator=gen, device=dev),
        torch.arange(n, pad, device=dev)]) for _ in range(m)])
        for n in ns]).to(torch.int32)
    operands = localsearch._two_opt_operands(bt.problem.dist, bt.problem.nn,
                                             tours, na)
    flat = [x.reshape(nb * m, -1) for x in operands[:5]]
    del operands
    per_slot = [[x[i * m:(i + 1) * m] for x in flat] for i in range(nb)]
    for mode in ("best", "first"):
        got = topt.two_opt_best(*flat, thr=1e-3, mode=mode)
        want = topt.two_opt_best_plain(*flat, thr=1e-3, mode=mode)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"two_opt_best fold != plain ({mode})")
        for i in range(nb):
            one = topt.two_opt_best(*per_slot[i], thr=1e-3, mode=mode)
            if not (torch.equal(got[0][i * m:(i + 1) * m], one[0])
                    and torch.equal(got[1][i * m:(i + 1) * m], one[1])):
                raise AssertionError(f"two_opt_best fold slot {i} != its "
                                     f"single launch ({mode})")
    check_s = time.perf_counter() - t0
    timed = {
        "choice_info": (
            lambda: ci.choice_info(tau, eta, 1.0, 2.0, na),
            lambda: [ci.choice_info(tau[i], eta[i], 1.0, 2.0, ns[i])
                     for i in range(nb)]),
        "tour_select": (
            lambda: ts.tour_select(rows, visited, rand, "iroulette", na),
            lambda: [ts.tour_select(rows[i], visited[i], rand[i],
                                    "iroulette", ns[i]) for i in range(nb)]),
        "two_opt_best": (
            lambda: topt.two_opt_best(*flat, thr=1e-3, mode="best"),
            lambda: [topt.two_opt_best(*per_slot[i], thr=1e-3, mode="best")
                     for i in range(nb)]),
    }
    for name, (stack_fn, singles_fn) in timed.items():
        st_dev, si_dev = device_ms(stack_fn), device_ms(singles_fn)
        st_call, si_call = cuda_ms(stack_fn), cuda_ms(singles_fn)
        log(f"[kernels] {name} stack B={nb} at bucket {pad} (m={m}"
            + (f", M={flat[0].shape[1]}" if name == "two_opt_best" else "")
            + f"): device {st_dev * 1e3:.2f} us vs {si_dev * 1e3:.2f} us for "
            f"{nb} single launches (ratio {st_dev / si_dev:.3f}); per call "
            f"{st_call * 1e3:.1f} us vs {si_call * 1e3:.1f} us (ratio "
            f"{st_call / si_call:.3f})")
    log(f"[kernels] stacks at bucket {pad}, n_actual={list(ns)}, slot 1 "
        f"inactive: choice_info (a/b 1/2, 2/3) and tour_select "
        f"({'/'.join(MODES)}) bitwise single launches and plain; "
        f"two_opt_best over the folded ({nb * m}, {flat[0].shape[1]}) rows "
        f"bitwise one launch per slot and plain, best and first "
        f"({check_s:.1f} s)")


def _dense_walk_operands(n, n_act, dtype, seed, window=None):
    """One dense walk's operands at m = n ants: the problem of
    ``random_instance(n, seed=n)`` (padded to n with ``n_act`` real cities),
    a random tau in [1e-4, 1.1e-3) stored as ``dtype`` (stochastically
    rounded), each ant on a random real city.  With ``window``, the walk's
    last ``window`` steps from a random mid-walk state: every city but
    ``window`` visited, the ant on a visited one.  Returns (eta, payload,
    int8 scale or None, start, key, visited or None, first step)."""
    import torch
    from repro_torch.core import aco, quant, sampling, tsp
    dev = torch.device("cuda")
    inst = tsp.random_instance(n, seed=n) if n_act is None else \
        tsp.pad_instance(tsp.random_instance(n_act, seed=n), n)
    eta = aco.make_problem(inst, 10, dev).eta
    gen = torch.Generator(device=dev).manual_seed(seed)
    tau = torch.rand((n, n), generator=gen, device=dev) * 1e-3 + 1e-4
    q, scale = tau, None
    if dtype != "fp32":
        qt = quant.quantise(tau, dtype, key=sampling.prng_key(seed, dev))
        q, scale = qt.q, (qt.scale if dtype == "int8" else None)
    key = sampling.prng_key(seed + 1, dev)
    if window is None:
        start = torch.randint(0, n_act or n, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        return eta, q, scale, start, key, None, 1
    perm = torch.rand((n, n), generator=gen, device=dev).argsort(dim=1)
    visited = torch.zeros((n, n), dtype=torch.bool, device=dev)
    visited.scatter_(1, perm[:, :n - window], True)
    start = perm[:, 0].to(torch.int32).contiguous()
    return eta, q, scale, start, key, visited, n - window


def _dense_walk(fn, operands, mode, draw, n_act, **kw):
    eta, q, scale, start, key, visited, first = operands
    return fn(q, eta, start, key, 1.0, 2.0, n_act, mode, draw, scale,
              visited, first, **kw)


def phase_dense_walk(results: dict) -> None:
    """The dense walk kernel (fp32, int8, bf16 payloads) against the plain
    walk on the card (every step through the full draw and
    ``fused_select_plain``), bitwise: whole walks at n = m = 1002 over the
    three payloads, three modes and both draws; the last 200 steps of a
    walk at n = m = 2392 over the same grid, and one whole walk there; an
    odd n (997) and a padded instance (901 real cities of 1002).  Then each
    payload's time per launch at n = m = 1002 and 2392 beside the per-step
    route it replaced (the one-step kernel over the plain draw, once a
    step), the plain walk and the bound."""
    import torch
    from repro_torch.kernels import fused_select as fs, ops
    t0 = time.perf_counter()
    full = [(mode, draw) for mode in MODES for draw in ("packed", "counter")
            if mode != "greedy" or draw == "packed"]
    # (n, n_actual, payload, mode, draw, window)
    grid = [(1002, None, d, mode, draw, None) for d in ("fp32",) + QUANT
            for mode, draw in full]
    grid += [(2392, None, d, mode, draw, WALK_WINDOW)
             for d in ("fp32",) + QUANT
             for mode, draw in full]
    grid += [(2392, None, "fp32", "iroulette", "packed", None),
             (997, None, "fp32", "iroulette", "packed", None),
             (997, None, "int8", "gumbel", "counter", None),
             (997, None, "bf16", "greedy", "packed", None),
             (1002, 901, "fp32", "iroulette", "packed", None),
             (1002, 901, "int8", "iroulette", "counter", None),
             (1002, 901, "bf16", "gumbel", "packed", None),
             (1002, 901, "fp32", "greedy", "packed", None)]
    for n, n_act, dtype, mode, draw, window in grid:
        operands = _dense_walk_operands(n, n_act, dtype, 7, window)
        got = _dense_walk(ops.fused_walk, operands, mode, draw, n_act)
        want = _dense_walk(fs.fused_walk_plain, operands, mode, draw, n_act)
        if not torch.equal(got, want):
            bad = int((got != want).any(0).sum())
            raise AssertionError(
                f"fused_walk != plain walk for {bad} ants ({dtype}, {mode}, "
                f"{draw}, n={n}, n_actual={n_act}, window={window})")
    log(f"[kernels] fused_walk (fp32, int8, bf16): bitwise against the plain "
        f"walk on the card in {len(grid)} cases (whole walks at n=m=1002 x "
        f"3 payloads x iroulette, gumbel (packed, counter) and greedy; the "
        f"last {WALK_WINDOW} steps at n=m=2392 over the same grid and one "
        f"whole walk; "
        f"n=997; n_actual=901 of 1002) in {time.perf_counter() - t0:.0f} s")

    line = []
    for n in (1002, 2392):
        for dtype, name in (("fp32", "fused_walk"),
                            ("int8", "fused_walk_quant_int8"),
                            ("bf16", "fused_walk_quant_bf16")):
            operands = _dense_walk_operands(n, None, dtype, 8)
            eta, q, scale, start, key, _, _ = operands
            kern = lambda: _dense_walk(ops.fused_walk, operands,  # noqa: E731
                                       "iroulette", "packed", None)
            steps = kern()
            wall = cuda_ms(kern, reps=3, trials=3)
            own = [sum(us for k, us in device_split(kern, reps=1).items()
                       if "fused_walk_kernel" in k) for _ in range(3)]
            ms = statistics.median(own) / 1e3 if min(own) > 0 else wall
            # the route it replaced: the one-step kernel over the plain
            # per-step draw, once a step; at 2392 over the last 200 steps
            # of a walk (a whole one takes about 17 s)
            replaced = _dense_walk_operands(
                n, None, dtype, 8, None if n == 1002 else WALK_WINDOW)
            loop_wall = cuda_ms(lambda: _dense_walk(
                fs.fused_walk_plain, replaced, "iroulette", "packed", None,
                select=ops.fused_select), reps=1, trials=1, warmup=1)
            loop_steps = n - replaced[-1]
            # bytes: payload (+ int8 row scales), eta, start, key and the
            # cities once each; operations: the weight and transform at
            # each (step, ant, city) in float32, and a threefry hash at
            # each (step, ant, selectable city) plus the kernel's step keys
            # (every real weight is > 0 here, so the selectable cities are
            # the unvisited ones: n - t at step t of a valid tour)
            tours = torch.cat([start[None], steps]).T
            valid = bool((tours.sort(dim=1).values
                          == torch.arange(n, device=tours.device)).all())
            if not valid:
                raise AssertionError(f"{name} n={n}: a tour is not a "
                                     "permutation")
            m = start.shape[0]
            hashes = m * n * (n - 1) // 2 + m * -(-(n - 1) // 128) * 128
            nbytes = (n * n * (q.element_size() + 4) + m * 4 + 16
                      + m * (n - 1) * 4 + (n * 4 if scale is not None else 0))
            b_ms, b_by = bound(nbytes, m * (n - 1) * n * 5,
                               hashes * HASH_OPS)
            if n == 1002 and dtype == "fp32":
                # the hashes' share: greedy hashes nothing, gumbel adds two
                # logs to each hashed city
                by_mode = {mode: cuda_ms(lambda mode=mode: _dense_walk(
                    ops.fused_walk, operands, mode, "packed", None), reps=3,
                    trials=3) for mode in MODES}
                log(f"[kernels] fused_walk n=m=1002 fp32 per call by mode: "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in by_mode.items())
                    + " (greedy hashes nothing)")
            if n == 1002:
                plain_wall = cuda_ms(lambda: _dense_walk(
                    fs.fused_walk_plain, operands, "iroulette", "packed",
                    None), reps=1, trials=1, warmup=1)
                results[name] = {"max_abs_err": 0.0, "ms": ms,
                                 "plain_ms": plain_wall, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": None}
            line.append(f"{dtype} {ms:.3f}")
            log(f"[kernels] {name} n=m={n}, one launch ({n - 1} steps): "
                f"device {ms:.3f} ms, per call {wall:.3f} ms "
                f"({ms / (n - 1) * 1e3:.2f} us a step) | per-step route "
                f"(one-step kernel + plain draw) {loop_wall / loop_steps:.3f}"
                f" ms a step over {loop_steps} steps, {loop_wall:.1f} ms"
                + (f" | plain walk per call {plain_wall:.1f} ms"
                   if n == 1002 else "")
                + f" | bound {b_ms:.3f} ms by {b_by} ({nbytes / 1e6:.2f} "
                f"MB, {hashes} hashes x {HASH_OPS} integer operations at "
                f"{INT32_OPS_PER_S:.4g}/s) | library: none")
        log(f"[kernels] fused_walk n=m={n} device ms: {', '.join(line)}")
        line = []


def _gather_sectors(torch, cities, n, itemsize):
    """32-byte sectors that gathering one ``itemsize``-byte value per
    (ant, candidate id >= 0) touches in an (m, n) row-major tensor."""
    a = torch.arange(cities.shape[0], device=cities.device)[:, None]
    addr = (a * n + cities.long()) * itemsize
    return int(torch.unique(addr[cities >= 0] // 32).numel())


def phase_sparse_kernels(results: dict) -> None:
    """K7 and its int8/bf16 payload (K6's sparse half) against their plain
    versions, bitwise, in all three modes, at the sparse route's shapes;
    then each one's time and bound at (m, K) = (64, 20), n = 2392."""
    import torch
    from repro_torch.kernels import sparse_select as ss
    dev = torch.device("cuda")
    # (n, m, k): the route's two sizes at 64 ants, and m = n at the default
    # sparse_k = 32; K = k + 4 overflow positions
    for n, m, k in ((1002, SPARSE_M, SPARSE_K), (2392, SPARSE_M, SPARSE_K),
                    (2392, 2392, 32)):
        for dtype in ("fp32",) + QUANT:
            tau, scale, eta, cities, visited, rand = ss.page_operands(
                n, m, k, dtype, dev, seed=2)
            for mode in MODES:
                if dtype == "fp32":
                    got = ss.sparse_select(tau, eta, cities, visited, rand,
                                           1.0, 2.0, mode)
                    want = ss.sparse_select_plain(tau, eta, cities, visited,
                                                  rand, 1.0, 2.0, mode)
                else:
                    got = ss.sparse_select_quant(tau, scale, eta, cities,
                                                 visited, rand, 1.0, 2.0,
                                                 mode)
                    want = ss.sparse_select_quant_plain(
                        tau, scale, eta, cities, visited, rand, 1.0, 2.0,
                        mode)
                for g, w, what in zip(got, want, ("pos", "have")):
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"sparse_select[{dtype}] {what} != plain in "
                            f"{int((g != w).sum())} ants at n={n} m={m} "
                            f"K={k + 4} mode={mode}")
            if int(got[1][:4].sum()) != 0 or int(got[1][4:].sum()) == 0:
                raise AssertionError("sparse_select: the visited pages' "
                                     "have bits are wrong")
        log(f"[kernels] sparse_select (fp32, int8, bf16) n={n} m={m} "
            f"K={k + 4}: bitwise in {', '.join(MODES)} (pages fully "
            f"visited and ids < 0 included)")

    def both(fn, reps):
        wall = cuda_ms(fn, reps=reps)
        dev_ms = device_ms(fn)
        return (wall if dev_ms is None else dev_ms), wall

    n, m, k = SPARSE_N, SPARSE_M, SPARSE_K
    for dtype, name in (("fp32", "sparse_select"),
                        ("int8", "sparse_select_quant_int8"),
                        ("bf16", "sparse_select_quant_bf16")):
        tau, scale, eta, cities, visited, rand = ss.page_operands(
            n, m, k, dtype, dev, seed=3)
        if dtype == "fp32":
            kern = lambda: ss.sparse_select(tau, eta, cities, visited,  # noqa: E731,E501
                                            rand)
            plain = lambda: ss.sparse_select_plain(tau, eta, cities,  # noqa: E731,E501
                                                   visited, rand)
        else:
            kern = lambda: ss.sparse_select_quant(tau, scale, eta,  # noqa: E731,E501
                                                  cities, visited, rand)
            plain = lambda: ss.sparse_select_quant_plain(  # noqa: E731
                tau, scale, eta, cities, visited, rand)
        kk = cities.shape[1]
        # ids, tau (+ int8 scale) and eta read once, the two gathers as the
        # 32-byte sectors this input touches, pos and have written once
        nbytes = (m * kk * (4 + tau.element_size() + 4)
                  + (m * kk * 4 if scale is not None else 0)
                  + 32 * _gather_sectors(torch, cities, n, 1)
                  + 32 * _gather_sectors(torch, cities, n, 4) + m * 8)
        ops_n = m * kk * (6 + (1 if scale is not None else 0))
        ms, wall = both(kern, 50)
        plain_ms, plain_wall = both(plain, 10)
        b_ms, b_by = bound(nbytes, ops_n)
        results[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None}
        log(f"[kernels] {name} n={n} m={m} K={kk}: device {ms * 1e3:.2f} "
            f"us, per call {wall * 1e3:.1f} us | plain device "
            f"{plain_ms * 1e3:.1f} us, per call {plain_wall * 1e3:.1f} us | "
            f"bound {b_ms * 1e3:.3f} us by {b_by} ({nbytes / 1e3:.1f} kB) | "
            f"library: none")
    phase_walk_kernel(results)


def _walk(fn, operands, mode, draw, ewt, n_act, **kw):
    """One walk over a copy of the operands' visited rows -> (cities,
    lengths, fallbacks, visited)."""
    problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
    vis = visited.clone()
    out = fn(problem, tau, ovf_city, ovf_tau, start, vis, keys, mode, 1.0,
             2.0, ewt, draw, n_act, **kw)
    return (*out, vis)


def k7_loop(problem, tau, ovf_city, ovf_tau, start, visited, keys, mode,
            alpha, beta, ewt, draw, n_act):
    """The route the walk kernel replaced: the host loop of plain steps
    with the one-step K7 (``sparse_select``) launched once a step, for
    timing beside the walk."""
    from repro_torch.kernels import ops
    from repro_torch.sparse import construct
    return construct.host_walk(problem, tau, ovf_city, ovf_tau, start,
                               visited, keys, start.shape[0], mode, alpha,
                               beta, ewt, True, draw, n_act,
                               select=ops.sparse_select)


def phase_walk_kernel(results: dict) -> None:
    """The sparse walk kernel at the route's shapes (n = 2392, k = 16 + 4,
    m = 64) against the plain walk on the card (every step through the
    plain versions): cities, edge lengths, fallback counts and visited
    rows bitwise over float32, int8 and bf16 pages, the three modes and
    both draws (whole walks and each walk's last 200 steps), a padded
    instance and Partial-ACO windows; then its time
    per launch beside the plain walk and the per-step loop it replaced (K7
    launched once a step), with its byte bound and its latency floor."""
    import torch
    from repro_torch.kernels import sparse_select as ss
    dev = torch.device("cuda")
    n, m, k, o = SPARSE_N, SPARSE_M, SPARSE_K, 4
    ewt = "EUC_2D"
    # (payload, mode, draw, n_pad, window): whole walks of n - 1 steps, and
    # the grid over payloads, modes and draws from a mid-walk state (every
    # city visited but 200: the walk's last 200 steps, where the fallback
    # is taken most) to keep the plain walks' time in bounds; greedy draws
    # nothing, so it runs under one draw mode; Partial-ACO's own window 64
    grid = [("fp32", "iroulette", "packed", None, None),
            ("fp32", "gumbel", "counter", None, None),
            ("fp32", "iroulette", "packed", n + 7, None)]
    grid += [(dtype, mode, draw, None, WALK_WINDOW)
             for dtype in ("fp32",) + QUANT
             for mode in MODES for draw in ("packed", "counter")
             if mode != "greedy" or draw == "packed"]
    grid += [(dtype, "iroulette", "packed", None, 64)
             for dtype in ("fp32",) + QUANT]
    t0 = time.perf_counter()
    fallbacks = 0
    for dtype, mode, draw, n_pad, window in grid:
        operands = ss.walk_operands(n, m, k, o, dtype, dev, seed=5,
                                    n_pad=n_pad, window=window, ewt=ewt)
        n_act = operands[0].n_actual
        got = _walk(ss.sparse_walk, operands, mode, draw, ewt, n_act)
        want = _walk(ss.sparse_walk_plain, operands, mode, draw, ewt, n_act)
        for g, w, what in zip(got, want, ("cities", "lengths", "fallbacks",
                                          "visited")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"sparse_walk {what} != plain walk in "
                    f"{int((g != w).sum())} elements ({dtype}, {mode}, "
                    f"{draw}, n_pad={n_pad}, window={window})")
        fallbacks += int(got[2].sum())
    if fallbacks == 0:
        raise AssertionError("sparse_walk: the grid never took the fallback")
    log(f"[kernels] sparse_walk n={n} k={k}+{o} m={m}: bitwise against the "
        f"plain walk on the card in {len(grid)} cases (whole walks: fp32 "
        f"iroulette packed, gumbel counter, padded n={n + 7}; the last "
        f"{WALK_WINDOW} steps: fp32, int8, bf16 x iroulette, gumbel x packed, "
        f"counter and "
        f"greedy; Partial-ACO window 64 x 3 payloads; {fallbacks} fallback "
        f"steps) in {time.perf_counter() - t0:.0f} s")

    for dtype, name in (("fp32", "sparse_walk"),
                        ("int8", "sparse_walk_quant_int8"),
                        ("bf16", "sparse_walk_quant_bf16")):
        operands = ss.walk_operands(n, m, k, o, dtype, dev, seed=6, ewt=ewt)
        problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
        steps = keys.shape[0]
        kern = lambda: _walk(ss.sparse_walk, operands, "iroulette",  # noqa: E731,E501
                             "packed", ewt, None)
        cities, _, fbs, _ = kern()
        fb = int(fbs.sum())
        # threefry hashes: one at every real page position of every step
        # (the k candidates with an id >= 0 and the O overflow slots, an
        # empty one standing for the ant's own city)
        cur = torch.cat([start[None], cities[:-1]]).long()
        real = (problem.cand >= 0).sum(1) + o
        hashes = int(real[cur].sum())
        wall = cuda_ms(kern, reps=3, trials=3)
        # the walk kernel's own entry in three one-call profiles (the
        # tabu-row copy of each call excluded), median
        own = [sum(us for name, us in device_split(kern, reps=1).items()
                   if "sparse_walk_kernel" in name) for _ in range(3)]
        ms = statistics.median(own) / 1e3 if min(own) > 0 else wall
        plain_wall = cuda_ms(lambda: _walk(ss.sparse_walk_plain, operands,
                                           "iroulette", "packed", ewt, None),
                             reps=1, trials=1, warmup=1)
        loop_wall = cuda_ms(lambda: _walk(
            k7_loop, operands, "iroulette", "packed", ewt, None), reps=1,
            trials=1, warmup=1) if dtype == "fp32" else None
        # bytes, each input read once and each output written once: the
        # problem and page stores (coordinates, ids, distances, eta, the
        # payloads with their int8 row scales, overflow ids), the tabu rows
        # in and out, keys and start, the cities, lengths and fallbacks;
        # operations: the float work at each page position and each
        # fallback scan's lazy distances, and the hashes' integer work
        tau_b = ss._payload(tau)[0].element_size()
        nbytes = (n * 8 + n * k * 12 + n * (k + o) * tau_b + n * o * 4
                  + (8 * n if dtype == "int8" else 0) + 2 * m * n
                  + steps * 16 + m * 4 + steps * m * 8 + m * 4)
        b_ms, b_by = bound(nbytes, steps * m * (k + o) * 8 + fb * n * 8,
                           hashes * HASH_OPS)
        results[name] = {"max_abs_err": 0.0, "ms": ms,
                         "plain_ms": plain_wall, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
        log(f"[kernels] {name} n={n} k={k}+{o} m={m}, {steps} steps, one "
            f"launch: device {ms:.3f} ms, per call {wall:.3f} ms "
            f"({ms / steps * 1e3:.2f} us a step, {fb} fallback steps) | "
            f"plain walk per call {plain_wall:.1f} ms"
            + (f" | per-step loop (K7 a step) per call "
               f"{loop_wall:.1f} ms" if loop_wall is not None else "")
            + f" | bound {b_ms * 1e3:.2f} us by {b_by} ({nbytes / 1e6:.2f} "
            f"MB, {hashes} hashes x {HASH_OPS} integer operations at "
            f"{INT32_OPS_PER_S:.4g}/s); latency floor {steps} dependent "
            f"steps | library: none")


def _check_run(name, state, inst, n, slack):
    """Tour is a permutation; best_len finite and within `slack` of the
    nearest-neighbour tour."""
    import torch
    from repro_torch.core import tsp
    tour = state.best_tour.cpu().numpy()
    if not tsp.is_valid_tour(tour) or tour.shape != (n,):
        raise AssertionError(f"{name}: best tour is not a permutation")
    best = float(state.best_len)
    if not torch.isfinite(state.best_len):
        raise AssertionError(f"{name}: best_len {best} is not finite")
    _, c_nn = tsp.nearest_neighbour_tour(inst.distances())
    if best > slack * c_nn:
        raise AssertionError(f"{name}: best_len {best} > {slack} x the "
                             f"nearest-neighbour tour {c_nn}")
    return best, c_nn


def phase_small() -> None:
    """The multiply-add that the reference's compiler fuses, and the draw
    built on it, bitwise between the card and the CPU; then card kernel
    route == CPU plain route on small colonies (MMAS, AS, MMAS +
    2-opt/Or-opt and MMAS over a stochastic int8 store: tours, best_len and
    tau -- payload and scale -- bitwise; the AS deposits of all ants land
    in the CPU's order)."""
    import torch
    from repro_torch.core import aco, sampling, strategies, tsp
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    a, c = torch.rand((2, 1002, 1002), generator=gen)
    for b in (torch.tensor(0.9), torch.rand((1002, 1002), generator=gen)):
        want = torch.addcmul(c, b, a)
        got = torch.addcmul(c.cuda(), b.cuda(), a.cuda()).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"addcmul on the card != CPU in "
                                 f"{int((got != want).sum())} cells")
    # the compensated residual's multiply-subtract, as core/quant.py
    # writes it: a negated multiplicand (value=-1 rounds twice on the card)
    want = torch.addcmul(c, a.neg(), b)
    got = torch.addcmul(c.cuda(), a.cuda().neg(), b.cuda()).cpu()
    if not torch.equal(got, want):
        raise AssertionError(f"addcmul(c, -a, b) on the card != CPU in "
                             f"{int((got != want).sum())} cells")
    for mode in ("packed", "counter"):
        want = strategies._draw_step_uniform(sampling.prng_key(7, "cpu"),
                                             (1002, 1002), mode)
        got = strategies._draw_step_uniform(sampling.prng_key(7, "cuda"),
                                            (1002, 1002), mode).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"{mode} draw on the card != CPU in "
                                 f"{int((got != want).sum())} cells")
    log("[small] addcmul (one rounding; also with a negated multiplicand) "
        "and the per-step draw at (1002, 1002): card == CPU bitwise")
    inst = tsp.random_instance(100, seed=5)
    # (label, cfg kwargs, iterations, tau bitwise, kernels it must launch)
    for label, kw, iters, tau_exact, kernels in (
            ("mmas", dict(variant="mmas"), 10, True, ("fused_walk",)),
            ("as", dict(variant="as"), 1, True, ("fused_walk",)),
            ("mmas + 2opt_oropt", dict(variant="mmas",
                                       local_search="2opt_oropt"), 3, True,
             ("fused_walk", "two_opt_best")),
            ("mmas + int8 stochastic", dict(variant="mmas", tau_dtype="int8",
                                            tau_round="stochastic"), 10, True,
             ("fused_walk_quant",))):
        cfg = aco.ACOConfig(iterations=iters, seed=3, use_pallas=True, **kw)
        ops.reset_launch_counts()
        gpu = aco.run(inst, cfg, device="cuda")
        counts = ops.launch_counts()
        cpu = aco.run(inst, cfg, device="cpu")
        same = (torch.equal(gpu.best_tour.cpu(), cpu.best_tour)
                and torch.equal(gpu.best_len.cpu(), cpu.best_len))
        if not same:
            raise AssertionError(f"small {label}: card route != CPU route")
        # a quantised tau compares payload, scale and residual
        tau_g = gpu.tau if isinstance(gpu.tau, tuple) else (gpu.tau,)
        tau_c = cpu.tau if isinstance(cpu.tau, tuple) else (cpu.tau,)
        for tg, tc in zip(tau_g, tau_c):
            if tau_exact:
                if not torch.equal(tg.cpu(), tc):
                    raise AssertionError(f"small {label}: tau differs")
            else:
                torch.testing.assert_close(tg.cpu(), tc, rtol=1e-5,
                                           atol=1e-7)
        for k in kernels + ("pheromone_update_tours",):
            if counts[k] == 0:
                raise AssertionError(f"small {label}: {k} never launched")
        best, c_nn = _check_run(f"small {label}", gpu, inst, 100,
                                1.0 if label.startswith("mmas") else 1.5)
        log(f"[small] rand100 {label} x{iters}: card == CPU (tours, "
            f"best_len, tau {'bitwise' if tau_exact else 'rtol 1e-5'}); "
            f"best {best:.1f} vs nearest-neighbour tour {c_nn:.1f}; "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))


def phase_small_sparse() -> None:
    """Card kernel route == CPU plain route on small sparse colonies
    (rand100, sparse_k = 4, 4 overflow slots, 16 ants): MMAS, the same with
    Partial-ACO, and MMAS over an int8 store.  Tours, best_len, tau
    (payload, scale, residual), tau_def, ovf_city and ovf_tau bitwise; the
    data-parallel runs must take the page-fault fallback, adopt off-list
    edges into overflow slots and evict one."""
    import torch
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    from repro_torch.sparse import construct
    inst = tsp.random_instance(100, seed=5)

    def leaves(state):
        for x in state:
            yield from (x if isinstance(x, tuple) else (x,))

    for label, kw, kernel in (
            ("mmas", dict(), "sparse_walk"),
            ("mmas partial", dict(construction="partial", partial_window=16),
             "sparse_walk"),
            ("mmas int8", dict(tau_dtype="int8"), "sparse_walk")):
        cfg = aco.ACOConfig(variant="mmas", sparse=True, sparse_k=4,
                            sparse_overflow=4, m=16, iterations=10, seed=3,
                            use_pallas=True, **kw)
        runs, churn = {}, {}
        for dev in ("cuda", "cpu"):
            prev, adopted, evicted = [None], [0], [0]

            def record(state, prev=prev, adopted=adopted, evicted=evicted):
                oc = state.ovf_city.cpu()
                was = prev[0] if prev[0] is not None else torch.full_like(
                    oc, -1)
                changed = oc != was
                adopted[0] += int((changed & (was < 0)).sum())
                evicted[0] += int((changed & (was >= 0)).sum())
                prev[0] = oc

            ops.reset_launch_counts()
            construct.walk.fallbacks = 0
            runs[dev] = aco.run(inst, cfg, device=dev, checkpoint_cb=record,
                                checkpoint_every=1)
            churn[dev] = (adopted[0], evicted[0],
                          int(construct.walk.fallbacks), ops.launch_counts())
        for g, c in zip(leaves(runs["cuda"]), leaves(runs["cpu"])):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"small sparse {label}: card route != "
                                     "CPU route")
        adopted, evicted, fallbacks, counts = churn["cuda"]
        if counts[kernel] != cfg.iterations or counts["sparse_select"] or \
                counts["sparse_select_quant"] or \
                churn["cuda"][:3] != churn["cpu"][:3]:
            raise AssertionError(f"small sparse {label}: {kernel} "
                                 f"launched {counts[kernel]} times (one per "
                                 f"iteration expected, no one-step K7); "
                                 f"churn card {churn['cuda'][:3]} cpu "
                                 f"{churn['cpu'][:3]}")
        if "construction" not in kw and not (adopted and evicted
                                             and fallbacks):
            raise AssertionError(f"small sparse {label}: adoption "
                                 f"{adopted}, eviction {evicted}, fallback "
                                 f"{fallbacks}: each must occur")
        best, c_nn = _check_run(f"small sparse {label}", runs["cuda"], inst,
                                100, 1.2)
        log(f"[small] rand100 sparse {label} k=4+4 x10: card == CPU (tours, "
            f"best_len, tau, tau_def, ovf_city, ovf_tau bitwise); "
            f"{adopted} adoptions, {evicted} evictions, {fallbacks} fallback "
            f"(ant, step) pairs; best {best:.1f} vs NN tour {c_nn:.1f}; "
            f"{kernel}={counts[kernel]}")


def phase_main(launches: dict) -> None:
    import torch
    from repro_torch.core import aco, localsearch, tsp
    from repro_torch.kernels import ops
    # (label, n, cfg kwargs, expected launches per iteration, the most
    # best_len may be as a multiple of the nearest-neighbour tour, the
    # iteration cap when the run goes on until it meets that limit).  MMAS
    # and MMAS + 2-opt run until they reach that tour; the others take a
    # few iterations and are held to 1.2 x it.  The 2-opt reduction's
    # launches are checked against the rounds localsearch.improve reports.
    dense = {"fused_walk": 1, "pheromone_update_tours": 1}
    quantised = {"fused_walk_quant": 1, "pheromone_update_tours": 1}
    runs = [
        ("as", 1002, dict(variant="as", iterations=3), dense, 1.2, None),
        ("mmas", 1002, dict(variant="mmas", iterations=2 * MMAS_CHUNK),
         dense, 1.0, MMAS_CAP),
        ("acs", 1002, dict(variant="acs", iterations=3), dense, 1.2, None),
        ("as-pallas", 1002, dict(variant="as", iterations=2,
                                 construction="pallas"),
         {"choice_info": 1, "tour_select": 1001, "pheromone_update_tours": 1},
         1.2,
         None),
        ("mmas+2opt", 1002, dict(variant="mmas", local_search="2opt",
                                 iterations=MMAS_CHUNK), dense, 1.0,
         MMAS_CAP),
        ("acs+2opt_oropt", 1002, dict(variant="acs",
                                      local_search="2opt_oropt",
                                      ls_improvement="first", ls_every=2,
                                      iterations=3), dense, 1.2, None),
        ("mmas-int8", 1002, dict(variant="mmas", tau_dtype="int8",
                                 iterations=3), quantised, 1.2, None),
        ("as-bf16", 1002, dict(variant="as", tau_dtype="bf16",
                               iterations=3), quantised, 1.2, None),
        ("as", 2392, dict(variant="as", iterations=3),
         dense, 1.2, None),
    ]
    instances = {}
    first_best = {}     # best_len after the first iteration, by label
    for label, n, kw, per_iter, slack, cap in runs:
        inst = instances.setdefault(n, tsp.random_instance(n))
        _, c_nn = tsp.nearest_neighbour_tour(inst.distances())
        cfg = aco.ACOConfig(use_pallas=True, seed=0, **kw)
        bests = []      # best_len after each iteration
        record = dict(checkpoint_cb=lambda s: bests.append(float(s.best_len)),
                      checkpoint_every=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        localsearch.improve.rounds = 0
        t0 = time.perf_counter()
        state = aco.run(inst, cfg, device="cuda", **record)
        # resume from the state in chunks until the limit or the cap
        while cap and bests[-1] > slack * c_nn and len(bests) < cap:
            cfg = dataclasses.replace(cfg, iterations=len(bests) + MMAS_CHUNK)
            state = aco.run(inst, cfg, state=state, **record)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        rounds = localsearch.improve.rounds
        want = {k: v * cfg.iterations for k, v in per_iter.items()}
        if cfg.local_search in ("2opt", "2opt_oropt"):
            if rounds == 0:
                raise AssertionError(f"main {label}: no local-search round")
            want["two_opt_best"] = rounds
        for k in counts:
            if counts[k] != want.get(k, 0):
                raise AssertionError(f"main {label} n={n}: {k} launched "
                                     f"{counts[k]} times, expected "
                                     f"{want.get(k, 0)}")
            name = k if k != "fused_walk_quant" else \
                f"fused_walk_quant_{cfg.tau_dtype}"
            launches[name] = launches.get(name, 0) + counts[k]
        best, c_nn = _check_run(f"main {label} n={n}", state, inst, n, slack)
        first_best[label] = bests[0]
        if label == "mmas+2opt" and bests[0] > first_best["mmas"]:
            raise AssertionError(
                f"main {label}: best after the first iteration {bests[0]} is "
                f"worse than plain MMAS's {first_best['mmas']}")
        log(f"[main] {label} n=m={n} x{cfg.iterations}: "
            f"{cfg.iterations / secs:.3f} it/s ({secs:.2f} s incl. set-up), "
            f"best {best:.1f} ({best / c_nn:.3f} x NN tour, limit {slack}), "
            f"launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
            + (f", local-search rounds {rounds}" if rounds else "")
            + f", peak mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        log(f"[main]   best / NN tour after each iteration: "
            + " ".join(f"{b / c_nn:.3f}" for b in bests))


def phase_sparse(launches: dict) -> None:
    """The sparse O(n·k) route at its users' size: ``aco.run`` with
    ``sparse=True`` on the kernel route, n = 2392, k = 16 (+ 4 overflow),
    m = 64, 10 iterations each.  MMAS data-parallel over fp32, int8 and
    bf16 pages, MMAS Partial-ACO (window 64), AS and ACS; each run launches
    the walk kernel once per iteration and the one-step K7 never."""
    import torch
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    from repro_torch.sparse import construct, store
    n, m, k = SPARSE_N, SPARSE_M, SPARSE_K
    inst = tsp.random_instance(n, seed=n)
    _, c_nn = store.sparse_nearest_neighbour_tour(inst)
    base = dict(sparse=True, sparse_k=k, m=m, use_pallas=True, seed=0,
                iterations=10)
    # (label, cfg kwargs, the walk kernel's entry, the most best_len may be
    # as a multiple of the NN tour); one sparse_walk launch per iteration,
    # data-parallel and Partial-ACO alike, and no one-step K7
    runs = [
        ("mmas", dict(variant="mmas"), "sparse_walk", 1.2),
        ("mmas-int8", dict(variant="mmas", tau_dtype="int8"),
         "sparse_walk_quant_int8", 1.2),
        ("mmas-bf16", dict(variant="mmas", tau_dtype="bf16"),
         "sparse_walk_quant_bf16", 1.2),
        ("mmas-partial", dict(variant="mmas", construction="partial",
                              partial_window=64), "sparse_walk", 1.0),
        ("as", dict(variant="as"), "sparse_walk", 1.2),
        ("acs", dict(variant="acs"), "sparse_walk", 1.2),
    ]
    for label, kw, kernel, slack in runs:
        cfg = aco.ACOConfig(**base, **kw)
        bests, slots, stamps = [], [], []

        def record(state, bests=bests, slots=slots, stamps=stamps):
            bests.append(float(state.best_len))     # waits for the card
            stamps.append(time.perf_counter())
            slots.append(int((state.ovf_city >= 0).sum()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        construct.walk.fallbacks = 0
        t0 = time.perf_counter()
        state = aco.run(inst, cfg, device="cuda", checkpoint_cb=record,
                        checkpoint_every=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        key = "sparse_walk"
        want = {key: cfg.iterations}
        for name, v in counts.items():
            if v != want.get(name, 0):
                raise AssertionError(f"sparse {label}: {name} launched {v} "
                                     f"times, expected {want.get(name, 0)}")
        launches[kernel] = launches.get(kernel, 0) + counts[key]
        best = float(state.best_len)
        if not (tsp.is_valid_tour(state.best_tour.cpu().numpy())
                and torch.isfinite(state.best_len)):
            raise AssertionError(f"sparse {label}: best tour is not a "
                                 f"permutation or best_len {best} not finite")
        if best > slack * c_nn:
            raise AssertionError(f"sparse {label}: best {best} > {slack} x "
                                 f"the NN tour {c_nn}")
        if label == "mmas-partial" and any(b > a for a, b in
                                           zip(bests, bests[1:])):
            raise AssertionError(f"sparse {label}: best rose: {bests}")
        prob = store.make_sparse_problem(inst, k, device="cuda")
        # steady state: the median time between two iterations' ends
        steady = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
        log(f"[sparse] {label} n={n} k={k}+4 m={m} x{cfg.iterations}: "
            f"{cfg.iterations / secs:.4f} it/s ({secs:.2f} s incl. set-up), "
            f"steady {1 / steady:.2f} it/s ({steady * 1e3:.1f} ms an "
            f"iteration, median), "
            f"best {best:.1f} ({best / c_nn:.4f} x NN tour, limit {slack}), "
            f"{key} launches {counts[key]} (sparse_select 0), fallback "
            f"(ant, step) pairs "
            f"{int(construct.walk.fallbacks)}, overflow slots in use "
            f"{slots[-1]} of {n * 4}, resident "
            f"{store.resident_bytes(prob, state)} B vs dense "
            f"{store.dense_resident_bytes(n)} B, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        log(f"[sparse]   best / NN tour after each iteration: "
            + " ".join(f"{b / c_nn:.4f}" for b in bests))


# The batched drain service at the paper's sizes: one bucket of 1024
# (n = 613 .. 1024) and one of 2048 (n = 1500 .. 2000); m follows the
# reference's rule, the padded width's num_ants.  The rehearsal on the CPU
# shrinks these.
DEV = "cuda"
BATCH_NS, BATCH_PAD = (613, 801, 1002, 1024), 1024
BATCH_SEEDS, BATCH_BUDGETS = (0, 1, 2, 3), (3, 5, 4, 5)
SPARSE_BATCH_NS, SPARSE_BATCH_PAD = (1500, 2000), 2048
SERVICE_NS = (613, 801, 1002, 1002, 1500, 2000)
SMALL_NS, SMALL_PAD = (40, 50, 64), 64


def _sync():
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def _leaves_equal(a, b) -> bool:
    import torch
    from repro_torch import tree
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree.flatten(a), tree.flatten(b)))


def _counted_batch(insts, cfg, **kw):
    """solve_instances on the card with launch counts zeroed first:
    (states, batch, counts, set-up + run seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.solver import engine
    _sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    states, b = engine.solve_instances(insts, cfg, device=DEV, **kw)
    _sync()
    return states, b, ops.launch_counts(), time.perf_counter() - t0


def _timed_run_batch(insts, cfg, seeds, budgets, n_pad):
    """Set-up (batch + states) and ``run_batch`` timed apart on the host
    clock around synchronised work: (states, batch, set-up s, run s)."""
    from repro_torch.solver import batch, engine
    _sync()
    t0 = time.perf_counter()
    b = batch.make_batch(insts, n_pad, cfg.nn_k, device=DEV)
    states = engine.init_states(insts, cfg, seeds, n_pad, device=DEV)
    _sync()
    t1 = time.perf_counter()
    states = engine.run_batch(b.problem, states, budgets, cfg, max(budgets),
                              donate=True)[0]
    _sync()
    return states, b, t1 - t0, time.perf_counter() - t1


def _check_counts(label, counts, want):
    for k, v in counts.items():
        if v != want.get(k, 0):
            raise AssertionError(f"{label}: {k} launched {v} times, "
                                 f"expected {want.get(k, 0)}")


def _check_padded_tours(label, states, insts, slack):
    """Each slot's real prefix is a permutation of its cities, the phantom
    tail in index order, and its best no worse than ``slack`` x its NN
    tour; returns best / NN tour per slot."""
    import numpy as np
    import torch
    from repro_torch.core import tsp
    tours = states.best_tour.cpu().numpy()
    ratios = []
    for i, inst in enumerate(insts):
        n, t = inst.n, tours[i]
        if not (np.array_equal(np.sort(t[:n]), np.arange(n))
                and np.array_equal(t[n:], np.arange(n, t.shape[0]))):
            raise AssertionError(f"{label} slot {i}: best tour is not a "
                                 "real permutation + phantom tail")
        best = float(states.best_len[i])
        if not torch.isfinite(states.best_len[i]):
            raise AssertionError(f"{label} slot {i}: best_len not finite")
        _, c_nn = tsp.nearest_neighbour_tour(inst.distances())
        if best > slack * c_nn:
            raise AssertionError(f"{label} slot {i}: best {best} > {slack} "
                                 f"x the NN tour {c_nn}")
        ratios.append(best / c_nn)
    return ratios


def _dense_stack_walks(ns, pad, nn_k, plain_cases):
    """One dense walk launch over a stack of ``len(ns)`` slots in bucket
    ``pad`` (m = pad, the bucket's own eta, the third slot inactive)
    bitwise the single launches over fp32/int8/bf16 x three modes x packed
    and counter draws, and bitwise the plain walks on the card in
    ``plain_cases`` ((payload, mode, draw) triples).  Returns the stack's
    operands (tau, eta, n_actual tensor, start, keys, active) and its fp32
    iroulette packed walk."""
    import torch
    from repro_torch.core import aco, quant, sampling, tsp
    from repro_torch.kernels import fused_select as fs, ops
    from repro_torch.solver import batch
    dev = torch.device(DEV)
    nb = len(ns)
    bt = batch.make_batch([tsp.random_instance(n, seed=n) for n in ns], pad,
                          nn_k, device=DEV)
    eta, n_act = bt.problem.eta, aco.slot_n_actual(bt.problem, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    tau = torch.rand((nb, pad, pad), generator=gen, device=dev) * 1e-3 + 1e-4
    start = torch.stack([torch.randint(0, n, (pad,), generator=gen,
                                       device=dev, dtype=torch.int32)
                         for n in ns])
    keys = torch.stack([sampling.prng_key(40 + i, dev) for i in range(nb)])
    active = tuple(i != 2 for i in range(nb))
    steps = None
    for dtype in ("fp32",) + QUANT:
        q, scale = tau, None
        if dtype != "fp32":
            qt = quant.quantise(tau, dtype, key=sampling.prng_key(3, dev))
            q, scale = qt.q, (qt.scale if dtype == "int8" else None)
        for mode in MODES:
            for draw in ("packed", "counter"):
                if mode == "greedy" and draw == "counter":
                    continue
                got = ops.fused_walk(q, eta, start, keys, 1.0, 2.0, n_act,
                                     mode, draw, tau_scale=scale,
                                     active=active)
                if got[2].any():
                    raise AssertionError("batched fused_walk wrote an "
                                         "inactive slot")
                for i in range(nb):
                    if not active[i]:
                        continue
                    one = ops.fused_walk(q[i], eta[i], start[i], keys[i],
                                         1.0, 2.0, ns[i], mode, draw,
                                         tau_scale=None if scale is None
                                         else scale[i])
                    if not torch.equal(got[i], one):
                        raise AssertionError(
                            f"batched fused_walk slot {i} != its single "
                            f"launch ({dtype}, {mode}, {draw}, bucket "
                            f"{pad})")
                if (dtype, mode, draw) in plain_cases:
                    want = fs.fused_walk_plain(q, eta, start, keys, 1.0, 2.0,
                                               n_act, mode, draw, scale,
                                               active=active)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"batched fused_walk != the plain walks "
                            f"({dtype}, {mode}, {draw}, bucket {pad})")
                if (dtype, mode, draw) == ("fp32", "iroulette", "packed"):
                    steps = got
    return (tau, eta, n_act, start, keys, active), steps


# The dense drain's smaller bucket (m = 512): the serving CLI's buckets
# are 512 and 1024.
DENSE_STACK_512 = (500, 511, 450, 512)
PLAIN_512 = (("fp32", "iroulette", "packed"), ("int8", "gumbel", "counter"),
             ("bf16", "greedy", "packed"))


def _batched_kernels(insts, cfg) -> None:
    """The instance axis at bucket 1024: one walk launch over the four
    slots' stack (the bucket's own eta, mixed n_actual, the third slot
    inactive) bitwise four single launches in fp32, int8 and bf16, all
    three modes and both draws, and the fp32 iroulette stack bitwise the
    plain walks on the card; the same at bucket 512 (m = 512) with three
    plain cases over the three payloads; one tours-driven update (AS,
    m = 1024, and MMAS, m = 1) over the stack bitwise single launches and
    the plain updates on the CPU.  Then the stack's walk with every slot
    active timed beside four single launches."""
    import torch
    from repro_torch.kernels import ops, pheromone_update as pu
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    nb = len(insts)
    _dense_stack_walks(DENSE_STACK_512, 512, cfg.nn_k, PLAIN_512)
    (tau, eta, n_act, start, keys, active), steps = _dense_stack_walks(
        BATCH_NS, BATCH_PAD, cfg.nn_k, (("fp32", "iroulette", "packed"),))
    gen = torch.Generator(device=dev).manual_seed(12)
    tours = torch.cat([start[:, None], steps], dim=1).transpose(1, 2)
    tours = tours.contiguous()
    for i in range(nb):
        if not active[i]:       # an inactive slot's tours: any permutation
            tours[i] = torch.arange(BATCH_PAD, dtype=torch.int32,
                                    device=dev)
    w = torch.rand((nb, BATCH_PAD), generator=gen, device=dev)
    for m in (BATCH_PAD, 1):
        got = ops.pheromone_update(tau, tours[:, :m].contiguous(),
                                   w[:, :m].contiguous(), 0.1, n_act,
                                   active=active)
        # the plain update on the CPU: the card's index_add_ sums a cell's
        # deposits in atomic order
        want = pu.pheromone_update_tours_plain(
            tau.cpu(), tours[:, :m].cpu(), w[:, :m].cpu(), 0.1, n_act.cpu(),
            active=active)
        for i in range(nb):
            if not active[i]:
                continue
            one = ops.pheromone_update(tau[i], tours[i, :m].contiguous(),
                                       w[i, :m].contiguous(), 0.1,
                                       BATCH_NS[i])
            if not (torch.equal(got[i], one)
                    and torch.equal(got[i].cpu(), want[i])):
                raise AssertionError(f"batched pheromone_update_tours slot "
                                     f"{i} (m={m}) != single / plain")
    stack_ms = cuda_ms(lambda: ops.fused_walk(tau, eta, start, keys, 1.0,
                                              2.0, n_act), reps=3, trials=3)
    single_ms = cuda_ms(lambda: [ops.fused_walk(
        tau[i], eta[i], start[i], keys[i], 1.0, 2.0, BATCH_NS[i])
        for i in range(nb)], reps=3, trials=3)
    upd_ms = cuda_ms(lambda: ops.pheromone_update(
        tau, tours[:, :1].contiguous(), w[:, :1].contiguous(), 0.1, n_act))
    upd_single = cuda_ms(lambda: [ops.pheromone_update(
        tau[i], tours[i, :1].contiguous(), w[i, :1].contiguous(), 0.1,
        BATCH_NS[i]) for i in range(nb)])
    log(f"[batched] instance axis, bucket {BATCH_PAD}, n={list(BATCH_NS)}: "
        f"one fused_walk launch over the stack (slot 2 inactive) bitwise "
        f"single launches in fp32/int8/bf16 x {'/'.join(MODES)} x packed/"
        f"counter, and the plain walks (fp32 iroulette); the same at bucket "
        f"512 (m=512, n={list(DENSE_STACK_512)}) and the plain walks in "
        f"{', '.join('/'.join(c) for c in PLAIN_512)}; one "
        f"pheromone_update_tours launch "
        f"(m={BATCH_PAD} and 1) bitwise single launches and the plain "
        f"updates on the CPU ({time.perf_counter() - t0:.1f} s) | time, "
        f"every slot "
        f"active: walk B={nb} {stack_ms:.3f} ms per launch vs "
        f"{single_ms:.3f} ms for {nb} single launches (ratio "
        f"{stack_ms / single_ms:.3f}); MMAS update B={nb} {upd_ms * 1e3:.1f} "
        f"us vs {upd_single * 1e3:.1f} us for {nb} single launches")


# The sparse walk's stacks: bucket 2048 (the [batched] engine's) and 4096
# (the serving CLI's sparse drain, n up to 2392), the second slot inactive.
SPARSE_STACK_NS = (2048, 1500, 2000, 1800)
SPARSE_STACK_4096 = (2392, 2100, 2300, 2049)
SPARSE_STACK_ACTIVE = (True, False, True, True)
SPARSE_STACK_WINDOW = 50


def _batched_sparse_kernels(ns, pad) -> None:
    """The sparse walk's instance axis in bucket ``pad``, B = 4, m = 64,
    k = 16 + 4 (the second slot inactive, the others padded but for an
    exact fit): one launch over the stack bitwise four single launches
    (cities, lengths, fallback counts, tabu rows) over fp32/int8/bf16
    pages x three modes x packed and counter draws, whole walks; the plain
    walks on the card over the same grid on each walk's last 50 steps, and
    the last slot's whole walk (its phantom tail).  Then the stack with
    every slot active timed beside four single launches."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_select as ss
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    act = SPARSE_STACK_ACTIVE
    grid = [(dtype, mode, draw) for dtype in ("fp32",) + QUANT
            for mode in MODES for draw in ("packed", "counter")
            if mode != "greedy" or draw == "packed"]
    ewt = "EUC_2D"
    checked = 0
    for window in (None, SPARSE_STACK_WINDOW):
        for dtype in ("fp32",) + QUANT:
            operands = ss.stack_walk_operands(ns, pad, SPARSE_M, SPARSE_K, 4,
                                              dtype, dev, seed=21,
                                              window=window, ewt=ewt)
            problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
            n_act = torch.tensor(problem.n_actual, dtype=torch.int32,
                                 device=dev)
            for dt, mode, draw in grid:
                if dt != dtype:
                    continue
                vis = visited.clone()
                got = ops.sparse_walk(problem, tau, ovf_city, ovf_tau, start,
                                      vis, keys, mode, 1.0, 2.0, ewt, draw,
                                      n_act, act)
                if got[0][1].any() or not torch.equal(vis[1], visited[1]):
                    raise AssertionError("batched sparse_walk wrote the "
                                         "inactive slot")
                if window is None:
                    wants = []
                    for b in range(len(ns)):
                        if not act[b]:
                            continue
                        v1 = visited[b].clone()
                        one = ops.sparse_walk(
                            problem.slot(b, ns[b]), tree.index(tau, b),
                            ovf_city[b], tree.index(ovf_tau, b), start[b],
                            v1, keys[b], mode, 1.0, 2.0, ewt, draw, ns[b])
                        wants.append((b, one + (v1,)))
                    if (dtype, mode, draw) == ("fp32", "iroulette",
                                               "packed"):
                        # one padded slot's whole plain walk: the tail
                        b = 3
                        v1 = visited[b].clone()
                        plain = ss.sparse_walk_plain(
                            problem.slot(b, ns[b]), tree.index(tau, b),
                            ovf_city[b], tree.index(ovf_tau, b), start[b],
                            v1, keys[b], mode, 1.0, 2.0, ewt, draw, ns[b])
                        wants.append((b, plain + (v1,)))
                else:
                    vp = visited.clone()
                    plain = ss.sparse_walk_plain(problem, tau, ovf_city,
                                                 ovf_tau, start, vp, keys,
                                                 mode, 1.0, 2.0, ewt, draw,
                                                 n_act, act)
                    wants = [(b, tuple(x[b] for x in plain) + (vp[b],))
                             for b in range(len(ns)) if act[b]]
                for b, want in wants:
                    mine = tuple(x[b] for x in got) + (vis[b],)
                    for g, w, what in zip(mine, want, ("cities", "lengths",
                                                       "fallbacks",
                                                       "visited")):
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"batched sparse_walk slot {b} {what} != "
                                f"{'single launch' if window is None else 'plain walk'} "
                                f"({dtype}, {mode}, {draw}, window "
                                f"{window})")
                checked += 1
    # every slot active: the stack's launch beside four single launches
    operands = ss.stack_walk_operands(ns, pad, SPARSE_M, SPARSE_K, 4, "fp32",
                                      dev, seed=22, ewt=ewt)
    problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
    n_act = torch.tensor(problem.n_actual, dtype=torch.int32, device=dev)
    stack_ms = cuda_ms(lambda: ops.sparse_walk(
        problem, tau, ovf_city, ovf_tau, start, visited.clone(), keys,
        "iroulette", 1.0, 2.0, ewt, "packed", n_act), reps=3, trials=3)
    slots = [(problem.slot(b, ns[b]), tau[b], ovf_city[b], ovf_tau[b],
              start[b], visited[b], keys[b], ns[b]) for b in range(len(ns))]
    single_ms = cuda_ms(lambda: [ops.sparse_walk(
        p, t, oc, ot, st, v.clone(), k, "iroulette", 1.0, 2.0, ewt, "packed",
        na) for p, t, oc, ot, st, v, k, na in slots], reps=3, trials=3)
    log(f"[batched] sparse walk instance axis, bucket {pad}, n={list(ns)}, "
        f"m={SPARSE_M}, k={SPARSE_K}+4: one launch over the stack (slot 1 "
        f"inactive) bitwise single launches (whole walks) and the plain "
        f"walks (last {SPARSE_STACK_WINDOW} steps; slot 3's whole walk) in "
        f"{checked} cases (fp32/int8/bf16 x {'/'.join(MODES)} x packed/"
        f"counter) ({time.perf_counter() - t0:.1f} s) | time, every slot "
        f"active: B={len(ns)} {stack_ms:.3f} ms per launch vs "
        f"{single_ms:.3f} ms for {len(ns)} single launches (ratio "
        f"{stack_ms / single_ms:.3f})")


def _batched_sparse_as() -> None:
    """Sparse AS (m = 64 ants deposit: the card's ``index_add_`` sums a
    cell's deposits in atomic order) at bucket 2048, one iteration: a solo
    run repeated, and each slot of the batched run against its solo run.
    Tours, lengths and keys bitwise; tau bitwise where the solo run is
    repeatable, else at rtol 1e-5 / atol 1e-7 (ROADMAP queue 3)."""
    import torch
    from repro_torch import tree
    from repro_torch.core import aco, tsp
    from repro_torch.solver import engine
    insts = [tsp.random_instance(n, seed=n) for n in SPARSE_BATCH_NS]
    cfg = aco.ACOConfig(variant="as", sparse=True, sparse_k=SPARSE_K,
                        m=SPARSE_M, use_pallas=True, iterations=1)
    batched, _ = engine.solve_instances(insts, cfg, seeds=[0, 1],
                                        n_pad=SPARSE_BATCH_PAD, device=DEV)
    repeatable, worst = True, 0.0
    for i, inst in enumerate(insts):
        runs = [engine.solve_instances([inst], cfg, seeds=[i],
                                       n_pad=SPARSE_BATCH_PAD, device=DEV)[0]
                for _ in range(2)]
        repeatable &= _leaves_equal(runs[0], runs[1])
        got, want = tree.index(batched, i), tree.index(runs[0], 0)
        for f in ("best_tour", "best_len", "iteration", "key", "ovf_city"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"batched sparse AS slot {i} {f} != "
                                     "solo")
        for f in ("tau", "tau_def", "ovf_tau"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=1e-5, atol=1e-7)
            diff = (getattr(got, f) - getattr(want, f)).abs()
            worst = max(worst, float((diff / getattr(want, f).abs().clamp_min(
                1e-30)).max()))
    log(f"[batched] sparse AS k={SPARSE_K}+4 m={SPARSE_M}, "
        f"n={list(SPARSE_BATCH_NS)} in bucket {SPARSE_BATCH_PAD}, x1: a solo "
        f"run repeated is {'bitwise' if repeatable else 'NOT bitwise'} "
        f"itself; batched == solo in tours, lengths, keys, ovf_city; tau "
        f"largest relative difference {worst:.3g} (limit rtol 1e-5)")


def _batched_sparse_profile() -> None:
    """One sparse MMAS engine iteration at B = 4 (n = 2048, 1500, 2000,
    1800 in bucket 2048, k = 16 + 4, m = 64), every slot active: wall time
    beside four solo engine iterations (in turns, best of two), then a
    ``torch.profiler`` pass: device busy time, idle share and the busiest
    kernels with their launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import aco, tsp
    from repro_torch.solver import batch, engine
    ns = SPARSE_STACK_NS
    insts = [tsp.random_instance(n, seed=n) for n in ns]
    cfg = aco.ACOConfig(variant="mmas", sparse=True, sparse_k=SPARSE_K,
                        m=SPARSE_M, use_pallas=True)
    pad = SPARSE_BATCH_PAD

    def prepared(group, seeds):
        sb = batch.make_sparse_batch(group, SPARSE_K, pad, device=DEV)
        s = engine.init_sparse_states(group, cfg, seeds, pad, DEV)
        s = engine.run_batch(sb.problem, s, [1] * len(group), cfg, 1,
                             kind="sparse", ewt=sb.ewt)[0]        # warm
        return sb, s

    def one_iteration(sb, s):
        _sync()
        t0 = time.perf_counter()
        engine.run_batch(sb.problem, s, [2] * s.key.shape[0], cfg, 1,
                         kind="sparse", ewt=sb.ewt)
        _sync()
        return (time.perf_counter() - t0) * 1e3

    stack = prepared(insts, [0, 1, 2, 3])
    solos = [prepared([inst], [i]) for i, inst in enumerate(insts)]
    walls, solo_sums = [], []
    for _ in range(2):
        walls.append(one_iteration(*stack))
        solo_sums.append(sum(one_iteration(*p) for p in solos))
    wall_ms, solo_ms = min(walls), min(solo_sums)
    acts = [ProfilerActivity.CUDA] if DEV == "cuda" else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        engine.run_batch(stack[0].problem, stack[1], [2] * 4, cfg, 1,
                         kind="sparse", ewt=stack[0].ewt)
        _sync()
    per_name = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0 and DEV == "cuda":
            per_name[e.key] = (per_name.get(e.key, (0.0, 0))[0] + us,
                               e.count)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    log(f"[batched] profile: one sparse engine iteration, B=4 MMAS slots "
        f"n={list(ns)}, bucket {pad}, k={SPARSE_K}+4, m={SPARSE_M}: wall "
        f"{wall_ms:.1f} ms (no profiler; runs "
        f"{', '.join(f'{w:.1f}' for w in walls)}) vs {solo_ms:.1f} ms for "
        f"four solo engine iterations (ratio {wall_ms / solo_ms:.3f}); "
        f"device busy {busy_ms:.1f} ms, device idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for name, (us, count) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
        log(f"[batched]   {us / 1e3:8.2f} ms  {count:6d} launches  "
            f"{name[:90]}")


def _batched_pallas(launches: dict) -> None:
    """AS on ``construction="pallas"`` over the [batched] bucket (n = 613,
    801, 1002, 1024 in bucket 1024, two iterations): one ``choice_info``
    launch and 1023 ``tour_select`` launches per engine iteration for the
    whole stack, every slot bitwise its solo run."""
    from repro_torch import tree
    from repro_torch.core import aco, tsp
    from repro_torch.solver import engine
    insts = [tsp.random_instance(n, seed=n) for n in BATCH_NS]
    cfg = aco.ACOConfig(variant="as", use_pallas=True, construction="pallas",
                        iterations=2)
    states, _, counts, secs = _counted_batch(
        insts, cfg, seeds=BATCH_SEEDS, n_pad=BATCH_PAD)
    steps = max(BATCH_NS) - 1
    _check_counts("batched as pallas", counts,
                  {"choice_info": 2, "tour_select": 2 * steps,
                   "pheromone_update_tours": 2})
    for k in ("choice_info", "tour_select", "pheromone_update_tours"):
        launches[k] = launches.get(k, 0) + counts[k]
    t0 = time.perf_counter()
    for i, inst in enumerate(insts):
        solo, _ = engine.solve_instances([inst], cfg, seeds=[BATCH_SEEDS[i]],
                                         n_pad=BATCH_PAD, device=DEV)
        if not _leaves_equal(tree.index(states, i), tree.index(solo, 0)):
            raise AssertionError(f"batched as pallas slot {i} (n={inst.n}) "
                                 "!= its solo run")
    solo_s = time.perf_counter() - t0
    ratios = _check_padded_tours("batched as pallas", states, insts, 1.3)
    log(f"[batched] AS construction=pallas, bucket {BATCH_PAD}, "
        f"n={list(BATCH_NS)}, x2: {secs:.2f} s incl. set-up (the four solo "
        f"runs {solo_s:.2f} s); every slot bitwise its solo run; "
        f"choice_info={counts['choice_info']}, tour_select="
        f"{counts['tour_select']} (= 2 x {steps}), pheromone_update_tours="
        f"{counts['pheromone_update_tours']}; best / NN tour "
        + " ".join(f"{r:.3f}" for r in ratios))


# MMAS + 2-opt over the [batched] bucket with ls_every = 2: the slots start
# at different iterations (a refilled streaming pool's), so the gate opens
# for different slots at each engine iteration.
LS_START, LS_BUDGETS = (0, 1, 2, 3), (3, 4, 5, 6)


def _batched_local_search(launches: dict) -> None:
    """MMAS + 2-opt (fp32, ``ls_every=2``) over four slots of bucket 1024
    whose counters start at 0, 1, 2, 3: one walk launch per engine
    iteration, one ``two_opt_best`` launch per round of the stack, every
    slot bitwise its solo run from the same state; then the peak memory of
    one 2-opt and one Or-opt round over the stack against
    ``BYTES_PER_MOVE``."""
    import torch
    from repro_torch import tree
    from repro_torch.core import aco, localsearch, tsp
    from repro_torch.kernels import ops
    from repro_torch.solver import batch, engine
    insts = [tsp.random_instance(n, seed=n) for n in BATCH_NS]
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True, local_search="2opt",
                        ls_every=2)
    b = batch.make_batch(insts, BATCH_PAD, cfg.nn_k, device=DEV)
    init = engine.init_states(insts, cfg, list(BATCH_SEEDS), BATCH_PAD,
                              device=DEV)
    init = init._replace(iteration=torch.tensor(LS_START, dtype=torch.int32,
                                                device=DEV))
    its = max(e - s for s, e in zip(LS_START, LS_BUDGETS))
    _sync()
    ops.reset_launch_counts()
    localsearch.improve.rounds = 0
    t0 = time.perf_counter()
    states = engine.run_batch(b.problem, init, list(LS_BUDGETS), cfg, its)[0]
    _sync()
    secs = time.perf_counter() - t0
    counts, rounds = ops.launch_counts(), localsearch.improve.rounds
    if rounds == 0:
        raise AssertionError("batched mmas+2opt: no local-search round")
    _check_counts("batched mmas+2opt ls_every=2", counts,
                  {"fused_walk": its, "pheromone_update_tours": its,
                   "two_opt_best": rounds})
    for k in ("fused_walk", "pheromone_update_tours", "two_opt_best"):
        launches[k] = launches.get(k, 0) + counts[k]
    solo_rounds = 0
    for i in range(len(insts)):
        localsearch.improve.rounds = 0
        one = aco.Problem(b.problem.dist[i:i + 1], b.problem.eta[i:i + 1],
                          b.problem.nn[i:i + 1], (b.problem.n_actual[i],))
        solo = engine.run_batch(one, tree.map(lambda x: x[i:i + 1], init),
                                [LS_BUDGETS[i]], cfg, its)[0]
        solo_rounds += localsearch.improve.rounds
        if not _leaves_equal(tree.index(states, i), tree.index(solo, 0)):
            raise AssertionError(f"batched mmas+2opt ls_every=2 slot {i} "
                                 "!= its solo run")
    if states.iteration.tolist() != list(LS_BUDGETS):
        raise AssertionError("batched mmas+2opt: iterations "
                             f"{states.iteration.tolist()}")
    # the peak of one 2-opt and one Or-opt round over the stack, beside
    # one slot's, in bytes a move
    m, n, k = BATCH_PAD, BATCH_PAD, b.problem.nn.shape[-1]
    tours = states.best_tour[:, None, :].expand(-1, m, -1).contiguous()
    ls_cfg = aco.ls_config(cfg)
    na = aco.slot_n_actual(b.problem, torch.device(DEV))
    peaks = {}
    for kind, round_fn in (("2opt", localsearch.two_opt_round),
                           ("oropt", localsearch.or_opt_round)):
        for group in (slice(0, len(insts)), slice(0, 1)):
            _sync()
            base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            round_fn(b.problem.dist[group], b.problem.nn[group],
                     tours[group], ls_cfg, na[group])
            _sync()
            peak = torch.cuda.max_memory_allocated() - base \
                if DEV == "cuda" else 0
            peaks.setdefault(kind, []).append(
                peak / (tours[group].shape[0] * m * n * k))
        if peaks[kind][0] > localsearch.BYTES_PER_MOVE:
            raise AssertionError(f"a {kind} round over the stack peaks at "
                                 f"{peaks[kind][0]:.1f} bytes a move, above "
                                 f"localsearch.BYTES_PER_MOVE")
    log(f"[batched] MMAS + 2-opt fp32 ls_every=2, bucket {BATCH_PAD}, "
        f"n={list(BATCH_NS)} from iterations {list(LS_START)} to "
        f"{list(LS_BUDGETS)}: {secs:.2f} s; every slot bitwise its solo run; "
        f"fused_walk={counts['fused_walk']} = engine iterations, "
        f"two_opt_best={counts['two_opt_best']} = the stack's rounds "
        f"(the four solo runs: {solo_rounds} rounds) | peak of one round: "
        + "; ".join(f"{kind} stack of {len(insts)} "
                    f"{p[0] * len(insts) * m * n * k / 2**30:.2f} GiB "
                    f"({p[0]:.1f} bytes a move), one slot "
                    f"{p[1] * m * n * k / 2**30:.2f} GiB ({p[1]:.1f})"
                    for kind, p in peaks.items())
        + f"; localsearch.BYTES_PER_MOVE {localsearch.BYTES_PER_MOVE}")


def _batched_iteration_profile(label: str, cfg, turns: int,
                               profiled: bool = True) -> None:
    """The first engine iteration of ``cfg`` at B = 4 (bucket 1024, every
    slot active, the kernels warm from the phases before) beside four solo
    engine iterations, in turns (best of ``turns``): wall time, the local
    search's share of it (host clock around each synchronised
    local-search pass), the peak memory above the resident state; then,
    when ``profiled``, a ``torch.profiler`` pass of the stack's iteration:
    device busy time, idle share and the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import localsearch, tsp
    from repro_torch.solver import batch, engine
    insts = [tsp.random_instance(n, seed=n) for n in BATCH_NS]

    def prepared(group, seeds):
        pb = batch.make_batch(group, BATCH_PAD, cfg.nn_k, device=DEV)
        return pb, engine.init_states(group, cfg, seeds, BATCH_PAD,
                                      device=DEV)

    ls_ms = [0.0]
    real = localsearch.improve_with_lengths

    def timed_ls(*a, **kw):
        _sync()
        t = time.perf_counter()
        out = real(*a, **kw)
        _sync()
        ls_ms[0] += (time.perf_counter() - t) * 1e3
        return out

    def one_iteration(pb, s):
        _sync()
        base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.run_batch(pb.problem, s, [1] * s.key.shape[0], cfg, 1)
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) \
            if DEV == "cuda" else 0
        ls_ms[0] = 0.0
        if cfg.local_search != "none":
            localsearch.improve_with_lengths = timed_ls
            try:
                engine.run_batch(pb.problem, s, [1] * s.key.shape[0], cfg, 1)
            finally:
                localsearch.improve_with_lengths = real
        return wall, ls_ms[0], peak

    stack = prepared(insts, list(BATCH_SEEDS))
    solos = [prepared([inst], [i]) for i, inst in enumerate(insts)]
    rows, solo_rows = [], []
    for _ in range(turns):
        rows.append(one_iteration(*stack))
        parts = [one_iteration(*p) for p in solos]
        solo_rows.append(tuple(sum(x[j] for x in parts) for j in range(2))
                         + (max(x[2] for x in parts),))
    wall, ls, peak = min(rows)
    s_wall, s_ls, s_peak = min(solo_rows)
    head = (f"[batched] {'profile' if profiled else 'time'}: one {label} "
            f"engine iteration, B=4, bucket {BATCH_PAD}: wall {wall:.1f} ms "
            f"(no profiler; runs {', '.join(f'{r[0]:.1f}' for r in rows)}) "
            f"vs {s_wall:.1f} ms for four solo engine iterations (ratio "
            f"{wall / s_wall:.3f}); local search {ls:.1f} ms "
            f"({ls / wall:.3f} of the wall; solo {s_ls:.1f} ms); peak memory "
            f"above the state {peak / 2**30:.2f} GiB (solo "
            f"{s_peak / 2**30:.2f})")
    if not profiled:
        log(head)
        return
    acts = [ProfilerActivity.CUDA] if DEV == "cuda" else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        engine.run_batch(stack[0].problem, stack[1], [1] * 4, cfg, 1)
        _sync()
    per_name = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0 and DEV == "cuda":
            per_name[e.key] = (per_name.get(e.key, (0.0, 0))[0] + us,
                               e.count)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    log(f"{head}; device busy {busy_ms:.1f} ms, device idle share "
        f"{1 - busy_ms / wall:.3f}")
    for name, (us, count) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
        log(f"[batched]   {us / 1e3:8.2f} ms  {count:6d} launches  "
            f"{name[:90]}")


def phase_batched(launches: dict) -> None:
    """The batched engine (``solver.engine``) on the kernel route: one
    bucket of four MMAS colonies at the paper's sizes, each slot bitwise
    its solo run; MMAS + 2-opt over an int8 store; a sparse bucket of 2048;
    small buckets card == CPU; the batched time beside the solo runs' and
    a profile of one engine iteration."""
    from repro_torch.core import aco, localsearch, tsp
    from repro_torch.kernels import ops
    from repro_torch.solver import batch, engine
    from repro_torch import tree

    # -- MMAS, four slots in one bucket, mixed budgets
    insts = [tsp.random_instance(n, seed=n) for n in BATCH_NS]
    budgets = list(BATCH_BUDGETS)
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True,
                        iterations=max(budgets))
    states, b, counts, secs = _counted_batch(
        insts, cfg, iterations=budgets, seeds=BATCH_SEEDS, n_pad=BATCH_PAD)
    total, engine_its = sum(budgets), max(budgets)
    # the instance axis: one walk and one update launch per engine
    # iteration, serving every active slot
    _check_counts("batched mmas", counts,
                  {"fused_walk": engine_its,
                   "pheromone_update_tours": engine_its})
    slot_counts = ops.slot_launch_counts()
    if (slot_counts["fused_walk"], slot_counts["pheromone_update_tours"]) \
            != (total, total):
        raise AssertionError(f"batched mmas: slot-launches {slot_counts} != "
                             f"the {total} slot-iterations")
    for k in ("fused_walk", "pheromone_update_tours"):
        launches[k] = launches.get(k, 0) + counts[k]
    if states.iteration.tolist() != budgets:
        raise AssertionError(f"batched mmas: iterations "
                             f"{states.iteration.tolist()} != {budgets}")
    for i, inst in enumerate(insts):
        solo, _ = engine.solve_instances(
            [inst], cfg, iterations=[budgets[i]], seeds=[BATCH_SEEDS[i]],
            n_pad=BATCH_PAD, device=DEV)
        if not _leaves_equal(tree.index(states, i), tree.index(solo, 0)):
            raise AssertionError(f"batched mmas slot {i} (n={inst.n}) != "
                                 "its solo run")
    # the unpadded slot is bitwise aco.run of the unpadded instance
    last = len(insts) - 1
    if insts[last].n == BATCH_PAD:
        plain = aco.run(insts[last], aco.ACOConfig(
            variant="mmas", use_pallas=True, iterations=budgets[last],
            seed=BATCH_SEEDS[last]), device=DEV)
        if not _leaves_equal(tree.index(states, last), plain):
            raise AssertionError("batched mmas: the exact-fit slot != "
                                 "aco.run of the unpadded instance")
    ratios = _check_padded_tours("batched mmas", states, insts, 1.2)
    log(f"[batched] MMAS bucket {BATCH_PAD}, n={list(BATCH_NS)}, budgets "
        f"{budgets}: {secs:.2f} s incl. set-up; every slot bitwise its solo "
        f"run (best_len, best_tour, iteration, key, tau), the n={BATCH_PAD} "
        f"slot bitwise aco.run unpadded; fused_walk={counts['fused_walk']}, "
        f"pheromone_update_tours={counts['pheromone_update_tours']} launches "
        f"= engine iterations, serving {slot_counts['fused_walk']} and "
        f"{slot_counts['pheromone_update_tours']} slot-iterations; one-step "
        f"kernels 0; best / NN tour " + " ".join(f"{r:.3f}" for r in ratios))
    _batched_kernels(insts, cfg)

    # -- the batched run beside the sum of its slots' solo runs (run_batch
    # only, set-up apart), in turns: batched, solo x4, batched
    bt_run, solo_run, bt_setup, solo_setup = [], [], [], []
    for _ in range(2):
        _, _, su, run = _timed_run_batch(insts, cfg, list(BATCH_SEEDS),
                                         budgets, BATCH_PAD)
        bt_setup.append(su)
        bt_run.append(run)
        su_sum = run_sum = 0.0
        for i, inst in enumerate(insts):
            _, _, su, run = _timed_run_batch([inst], cfg, [BATCH_SEEDS[i]],
                                             [budgets[i]], BATCH_PAD)
            su_sum += su
            run_sum += run
        solo_setup.append(su_sum)
        solo_run.append(run_sum)
    log(f"[batched] time: batched run_batch {min(bt_run) * 1e3:.1f} ms "
        f"(runs {', '.join(f'{t * 1e3:.1f}' for t in bt_run)}) = "
        f"{min(bt_run) / engine_its * 1e3:.1f} ms per engine iteration "
        f"({engine_its} engine iterations, {total} slot-iterations, "
        f"{min(bt_run) / total * 1e3:.2f} ms each) | sum of the four solo "
        f"run_batch calls {min(solo_run) * 1e3:.1f} ms (runs "
        f"{', '.join(f'{t * 1e3:.1f}' for t in solo_run)}) = "
        f"{min(solo_run) / engine_its * 1e3:.1f} ms per engine iteration; "
        f"batched / solo {min(bt_run) / min(solo_run):.3f} | set-up "
        f"batched {min(bt_setup):.2f} s, solo sum {min(solo_setup):.2f} s")

    # -- one engine iteration at B = 4, every slot active, profiled
    _batched_iteration_profile("MMAS", cfg, 2)

    # -- MMAS + 2-opt over an int8 store: two slots, two iterations
    pair = [insts[0], insts[2]]
    cfg_q = aco.ACOConfig(variant="mmas", use_pallas=True, iterations=2,
                          local_search="2opt", tau_dtype="int8")
    localsearch.improve.rounds = 0
    states, _, counts, secs = _counted_batch(pair, cfg_q, seeds=[0, 1],
                                             n_pad=BATCH_PAD)
    rounds = localsearch.improve.rounds
    if rounds == 0:
        raise AssertionError("batched mmas+2opt int8: no local-search round")
    # the stack: one walk and one update launch per engine iteration, one
    # two_opt_best launch per round of the stack's local search
    _check_counts("batched mmas+2opt int8", counts,
                  {"fused_walk_quant": 2, "pheromone_update_tours": 2,
                   "two_opt_best": rounds})
    launches["fused_walk_quant_int8"] = \
        launches.get("fused_walk_quant_int8", 0) + counts["fused_walk_quant"]
    launches["two_opt_best"] = launches.get("two_opt_best", 0) + rounds
    launches["pheromone_update_tours"] += 2
    for i, inst in enumerate(pair):
        solo, _ = engine.solve_instances([inst], cfg_q, seeds=[i],
                                         n_pad=BATCH_PAD, device=DEV)
        if not _leaves_equal(tree.index(states, i), tree.index(solo, 0)):
            raise AssertionError(f"batched mmas+2opt int8 slot {i} != solo")
    ratios = _check_padded_tours("batched mmas+2opt int8", states, pair,
                                 1.2)
    log(f"[batched] MMAS + 2-opt, int8 store, n={[i.n for i in pair]} in "
        f"bucket {BATCH_PAD}, x2: {secs:.2f} s incl. set-up; slots bitwise "
        f"their solo runs; fused_walk_quant={counts['fused_walk_quant']} = "
        f"engine iterations, two_opt_best={counts['two_opt_best']} = the "
        f"stack's local-search rounds {rounds}; best / NN tour "
        + " ".join(f"{r:.3f}" for r in ratios))
    _batched_pallas(launches)
    _batched_local_search(launches)
    _batched_iteration_profile("MMAS + 2-opt", aco.ACOConfig(
        variant="mmas", use_pallas=True, local_search="2opt"), 2)
    # the pallas iteration's 1023 steps make a long trace: timed only
    _batched_iteration_profile("AS construction=pallas", aco.ACOConfig(
        variant="as", use_pallas=True, construction="pallas"), 1,
        profiled=False)

    # -- sparse MMAS (k = 16 + 4, m = 64), bucket 2048, 10 iterations: the
    # instance axis, one walk launch per engine iteration for both slots
    sinsts = [tsp.random_instance(n, seed=n) for n in SPARSE_BATCH_NS]
    cfg_s = aco.ACOConfig(variant="mmas", sparse=True, sparse_k=SPARSE_K,
                          m=SPARSE_M, use_pallas=True, iterations=10)
    states, sb, counts, secs = _counted_batch(sinsts, cfg_s, seeds=[0, 1],
                                              n_pad=SPARSE_BATCH_PAD)
    _check_counts("batched sparse", counts, {"sparse_walk": 10})
    slot_counts = ops.slot_launch_counts()
    if slot_counts["sparse_walk"] != 10 * len(sinsts):
        raise AssertionError(f"batched sparse: slot-launches "
                             f"{slot_counts['sparse_walk']} != the "
                             f"{10 * len(sinsts)} slot-iterations")
    launches["sparse_walk"] = launches.get("sparse_walk", 0) + \
        counts["sparse_walk"]
    for i, inst in enumerate(sinsts):
        solo, _ = engine.solve_instances([inst], cfg_s, seeds=[i],
                                         n_pad=SPARSE_BATCH_PAD, device=DEV)
        if not _leaves_equal(tree.index(states, i), tree.index(solo, 0)):
            raise AssertionError(f"batched sparse slot {i} != solo")
    rows = engine.collect(states, sb)
    for r, inst in zip(rows, sinsts):
        if not tsp.is_valid_tour(r["best_tour"]) or r["iterations"] != 10:
            raise AssertionError(f"batched sparse {inst.n}: bad result")
    log(f"[batched] sparse MMAS k={SPARSE_K}+4 m={SPARSE_M}, "
        f"n={list(SPARSE_BATCH_NS)} in bucket {SPARSE_BATCH_PAD}, x10: "
        f"{secs:.2f} s incl. set-up; slots bitwise their solo runs; "
        f"sparse_walk={counts['sparse_walk']} launches = engine iterations, "
        f"serving {slot_counts['sparse_walk']} slot-iterations; best "
        + ", ".join(f"{r['best_len']:.1f}" for r in rows))
    _batched_sparse_kernels(SPARSE_STACK_NS, SPARSE_BATCH_PAD)
    _batched_sparse_kernels(SPARSE_STACK_4096, 4096)
    _batched_sparse_as()
    _batched_sparse_profile()

    # -- small buckets: the card's batched kernel route == the CPU's
    small = [tsp.random_instance(n, seed=n) for n in SMALL_NS]
    cases = [
        ("as", dict(variant="as"), {}),
        ("mmas + 2opt", dict(variant="mmas", local_search="2opt",
                             ls_rounds=8), {}),
        ("mmas int8", dict(variant="mmas", tau_dtype="int8"), {}),
        ("as pallas", dict(variant="as", construction="pallas"), {}),
        ("sparse mmas", dict(variant="mmas", sparse=True, sparse_k=6,
                             m=16), {}),
        ("mmas patience=2", dict(variant="mmas"), dict(patience=2)),
    ]
    for label, kw, call in cases:
        c = aco.ACOConfig(use_pallas=True, iterations=6, **kw)
        got, _ = engine.solve_instances(small, c, iterations=[6, 4, 5],
                                        seeds=[1, 2, 3], n_pad=SMALL_PAD,
                                        device=DEV, **call)
        want, _ = engine.solve_instances(small, c, iterations=[6, 4, 5],
                                         seeds=[1, 2, 3], n_pad=SMALL_PAD,
                                         device="cpu", **call)
        if not _leaves_equal(got, want):
            raise AssertionError(f"small batched {label}: card != CPU")
    c = aco.ACOConfig(variant="mmas", use_pallas=True, iterations=7)
    sb = batch.make_batch(small, SMALL_PAD, c.nn_k, device=DEV)
    init = engine.init_states(small, c, [1, 2, 3], SMALL_PAD, device=DEV)
    long = engine.run_batch(sb.problem, init, [7, 5, 6], c, 7, patience=2)
    carry = (init, None)
    for _ in range(4):
        carry = engine.run_batch(sb.problem, carry[0], [7, 5, 6], c, 2,
                                 patience=2, since=carry[1])
    if not _leaves_equal(long, carry):
        raise AssertionError("small batched: chunks of 2 != one long call")
    log(f"[batched] small buckets (n={list(SMALL_NS)}, bucket {SMALL_PAD}): "
        f"card == CPU bitwise for "
        + ", ".join(label for label, _, _ in cases)
        + "; a run chunked in 2s == one long call (patience=2)")


def phase_service(launches: dict) -> None:
    """``SolverService`` on the kernel route: six requests from two
    tenants into buckets 1024 and 2048, drained plain, checkpointed with a
    crash injected after a chunk, and with metrics off; the three agree
    bitwise, the first two in their metrics rows too; trace and events
    validate."""
    import tempfile
    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    from repro_torch.obs import validate
    from repro_torch.solver import engine, service
    insts = [tsp.random_instance(n, seed=i)
             for i, n in enumerate(SERVICE_NS)]
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True, metrics=True,
                        iterations=6)

    def drain(c, tel=None, **kw):
        svc = service.SolverService(c, max_batch=4, patience=3,
                                    telemetry=tel, device=DEV, **kw)
        for i, inst in enumerate(insts):
            svc.submit(inst, tenant=("tenant-a", "tenant-b")[i % 2])
        return svc, svc.run()

    with tempfile.TemporaryDirectory() as tmp:
        tel = obs.Telemetry(events_path=os.path.join(tmp, "events.jsonl"))
        _sync()
        ops.reset_launch_counts()
        svc, plain = drain(cfg, tel)
        _sync()
        counts, slot_counts = ops.launch_counts(), ops.slot_launch_counts()
        # one walk and one update launch per engine iteration of each job:
        # a job runs until its longest slot stops
        its = sum(r.iterations for r in plain)
        job_its = {}
        for r in plain:
            job_its[r.bucket] = max(job_its.get(r.bucket, 0), r.iterations)
        engine_its = sum(job_its.values())
        _check_counts("service", counts,
                      {"fused_walk": engine_its,
                       "pheromone_update_tours": engine_its})
        if slot_counts["fused_walk"] != its:
            raise AssertionError(f"service: {slot_counts['fused_walk']} "
                                 f"slot-launches != {its} slot-iterations")
        for k in ("fused_walk", "pheromone_update_tours"):
            launches[k] = launches.get(k, 0) + counts[k]
        tel.close()
        trace = tel.tracer.to_chrome()
        n_trace = validate.validate_chrome_trace(trace)
        n_events = validate.validate_event_log_file(
            os.path.join(tmp, "events.jsonl"))
        stats = svc.stats
        if stats["buckets"] != {str(BATCH_PAD): 4,
                                str(SPARSE_BATCH_PAD): 2} or \
                stats["batches"] != 2:
            raise AssertionError(f"service: buckets {stats['buckets']}, "
                                 f"batches {stats['batches']}")
        for r, inst in zip(plain, insts):
            if not (tsp.is_valid_tour(r.best_tour) and r.n == inst.n
                    and r.metrics["best_len"] == r.best_len):
                raise AssertionError(f"service: bad result {r.request_id}")

        # checkpointed, one crash injected after a chunk
        real_run_batch, real_save = engine.run_batch, CheckpointManager.save
        crashes, saves = {"left": 1}, []

        def flaky(*a, **kw):
            out = real_run_batch(*a, **kw)
            if int(out[0].iteration.max()) >= 4 and crashes["left"]:
                crashes["left"] -= 1
                raise RuntimeError("injected crash after chunk")
            return out

        def timed_save(self, step, state):
            _sync()
            t0 = time.perf_counter()
            real_save(self, step, state)
            saves.append(time.perf_counter() - t0)

        engine.run_batch, CheckpointManager.save = flaky, timed_save
        try:
            _, ckpt = drain(cfg, checkpoint_dir=os.path.join(tmp, "ck"),
                            ckpt_chunk=2)
        finally:
            engine.run_batch, CheckpointManager.save = real_run_batch, \
                real_save
        if crashes["left"]:
            raise AssertionError("service: the crash was never injected")
    _, off = drain(dataclasses.replace(cfg, metrics=False))
    for a, b, c in zip(plain, ckpt, off):
        if not (a.best_len == b.best_len == c.best_len
                and a.iterations == b.iterations == c.iterations
                and (a.best_tour == b.best_tour).all()
                and (a.best_tour == c.best_tour).all()):
            raise AssertionError(f"service request {a.request_id}: the "
                                 "three drains disagree")
        if a.metrics != b.metrics or c.metrics is not None:
            raise AssertionError(f"service request {a.request_id}: "
                                 "metrics rows differ")
    jobs = {}
    for r in plain:
        jobs.setdefault(r.bucket, r.solve_s)
    log(f"[service] MMAS kernel route, metrics on, max_batch 4, patience 3, "
        f"6 iterations: {len(plain)} requests from 2 tenants, buckets "
        f"{stats['buckets']}: {stats['instances_per_s']:.3f} instances/s, "
        f"wall {stats['wall_s']:.2f} s, latency mean "
        f"{stats['latency_mean_s']:.2f} s, max {stats['latency_max_s']:.2f} "
        f"s; solve_s per job "
        + ", ".join(f"bucket {k}: {v:.2f} s" for k, v in sorted(jobs.items()))
        + f"; iterations {[r.iterations for r in plain]}; "
        f"fused_walk={counts['fused_walk']} launches (engine iterations), "
        f"{slot_counts['fused_walk']} slot-launches")
    log(f"[service] plain == checkpointed with a crash (ckpt_chunk 2; "
        f"{len(saves)} saves, {statistics.median(saves) * 1e3:.1f} ms a "
        f"save, median, max {max(saves) * 1e3:.1f} ms) == metrics off: "
        f"best_len, best_tour, iterations bitwise; metrics rows equal; "
        f"trace ({n_trace} events) and event log ({n_events} records) "
        f"validate; best / request "
        + ", ".join(f"{r.best_len:.1f}" for r in plain))


# [streaming]: a Poisson trace of mixed sizes around pr1002 (bucket 1024),
# two larger requests (bucket 2048) and one request whose deadline lapses
# while it runs; the rehearsal on the CPU shrinks these.
STREAM_TRACE = dict(num=12, rate=20.0, min_n=520, max_n=1024, seed=0,
                    iterations=(4, 4, 4, 12), tenants=("a", "b"))
STREAM_BIG = (1500, 2000)
STREAM_DOOMED = dict(n=900, iterations=200, deadline=0.5)


def phase_streaming(launches: dict) -> None:
    """``StreamingSolverService`` on the kernel route (MMAS, metrics on,
    ``max_batch=4``, ``chunk=2``, ``max_waiting=6``): the trace replayed
    with mid-run admission into pools of buckets 1024 and 2048, beside one
    request that expires while it runs.  Every completed result bitwise
    its solo ``run_batch`` on the card (and the drain service's result);
    the expired one a valid partial tour with fewer iterations than its
    budget; walk and update launches equal to the pools' engine
    iterations, slot-launches to the slot-iterations; trace and events
    validate.  Then instances/s and latencies beside ``SolverService``
    draining the same requests."""
    import tempfile
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    from repro_torch.obs import validate
    from repro_torch.solver import engine, service, streaming
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True, metrics=True,
                        iterations=4)
    trace = streaming.make_poisson_trace(**STREAM_TRACE)
    big = [streaming.TraceItem(at=trace[k].at, instance=tsp.random_instance(
        n, seed=100 + k), iterations=4, seed=100 + k, tenant="b")
        for k, n in zip((3, 7), STREAM_BIG)]
    items = sorted(trace + big, key=lambda t: t.at)
    doomed_inst = tsp.random_instance(STREAM_DOOMED["n"], seed=99)

    # Engine iterations, counted from the slots themselves: each chunk keeps
    # its pool's (B,) iteration counts before and after (device copies, no
    # read in the timed run).  On the fused route a chunk takes as many
    # engine iterations as its busiest slot advanced; a per-slot loop would
    # take one per slot-iteration.
    real_chunk, chunk_its = streaming.StreamingPool.step_chunk, []

    def counted_chunk(pool, chunk):
        before = pool.states.iteration.clone()
        real_chunk(pool, chunk)
        chunk_its.append((before, pool.states.iteration.clone()))

    with tempfile.TemporaryDirectory() as tmp:
        tel = obs.Telemetry(events_path=os.path.join(tmp, "events.jsonl"))
        svc = streaming.StreamingSolverService(
            cfg, max_batch=4, chunk=2, max_waiting=6, telemetry=tel,
            device=DEV)
        streaming.StreamingPool.step_chunk = counted_chunk
        try:
            _sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            doomed = svc.submit(doomed_inst,
                                iterations=STREAM_DOOMED["iterations"],
                                seed=99, priority=1, tenant="a",
                                deadline=STREAM_DOOMED["deadline"])
            results = streaming.replay_trace(svc, items)
            _sync()
            wall = time.perf_counter() - t0
        finally:
            streaming.StreamingPool.step_chunk = real_chunk
        counts, slot_counts = ops.launch_counts(), ops.slot_launch_counts()
        tel.close()
        trace_json = tel.tracer.to_chrome()
        n_trace = validate.validate_chrome_trace(trace_json)
        n_events = validate.validate_event_log_file(
            os.path.join(tmp, "events.jsonl"))
    moved = [(after - before).tolist() for before, after in chunk_its]
    engine_its = sum(max(d) for d in moved)
    shared = sum(sum(d) - max(d) for d in moved)  # beyond one slot a chunk
    stats = svc.stats
    slot_its = sum(r.iterations for r in results)
    _check_counts("streaming", counts, {"fused_walk": engine_its,
                                        "pheromone_update_tours": engine_its})
    if (slot_counts["fused_walk"], slot_counts["pheromone_update_tours"]) \
            != (slot_its, slot_its) or sum(map(sum, moved)) != slot_its:
        raise AssertionError(f"streaming: slot-launches {slot_counts} != "
                             f"{slot_its} slot-iterations")
    if shared == 0:
        raise AssertionError("streaming: no chunk stepped two slots at once, "
                             "so the launch check shows nothing")
    for k in ("fused_walk", "pheromone_update_tours"):
        launches[k] = launches.get(k, 0) + counts[k]
    by_id = {r.request_id: r for r in results}
    if len(by_id) != len(items) + 1 or stats["completed"] != len(items) or \
            stats["expired_running"] != 1:
        raise AssertionError(f"streaming: {len(by_id)} results, stats "
                             f"completed {stats['completed']}, expired "
                             f"running {stats['expired_running']}")
    gone = by_id[doomed]
    if not (gone.expired and 1 <= gone.iterations
            < STREAM_DOOMED["iterations"] and len(gone.best_tour) == gone.n
            and tsp.is_valid_tour(gone.best_tour)
            and gone.best_len < float("inf")):
        raise AssertionError(f"streaming: the expired request is not a "
                             f"valid partial result ({gone.iterations} "
                             f"iterations)")
    # each completed request: bitwise its solo run on the card
    reqs = [(i + 1, it) for i, it in enumerate(items)]
    for rid, it in reqs:
        r = by_id[rid]
        solo, _ = engine.solve_instances(
            [it.instance], cfg, iterations=[it.iterations], seeds=[it.seed],
            n_pad=r.bucket, device=DEV)
        if r.expired or r.iterations != it.iterations or \
                r.best_len != float(solo.best_len[0]) or \
                not (r.best_tour == solo.best_tour[0][:r.n].cpu()
                     .numpy()).all():
            raise AssertionError(f"streaming request {rid} (n={r.n}) != "
                                 "its solo run")
    # the drain service on the same requests, all submitted at once
    drain = service.SolverService(cfg, max_batch=4, device=DEV)
    for _, it in reqs:
        drain.submit(it.instance, iterations=it.iterations, seed=it.seed,
                     tenant=it.tenant)
    _sync()
    drained = drain.run()
    _sync()
    for (rid, _), d in zip(reqs, drained):
        r = by_id[rid]
        if (d.best_len, d.iterations) != (r.best_len, r.iterations) or \
                not (d.best_tour == r.best_tour).all():
            raise AssertionError(f"streaming request {rid} != its drain "
                                 "result")
    ds = drain.stats
    # the drain service keeps no percentile: the same linear-interpolation
    # p95 as the streaming service's, over its results
    drain_p95 = float(np.percentile([d.latency_s for d in drained], 95))
    log(f"[streaming] MMAS kernel route, metrics on, max_batch 4, chunk 2, "
        f"max_waiting 6: {len(items)} requests (Poisson, rate "
        f"{STREAM_TRACE['rate']}/s, n {STREAM_TRACE['min_n']}-"
        f"{STREAM_TRACE['max_n']}, budgets {STREAM_TRACE['iterations']}, "
        f"+ n={list(STREAM_BIG)} in bucket {SPARSE_BATCH_PAD}) + 1 expiring "
        f"(n={STREAM_DOOMED['n']}, deadline {STREAM_DOOMED['deadline']} s, "
        f"evicted after {gone.iterations} of "
        f"{STREAM_DOOMED['iterations']} iterations): wall {wall:.2f} s; "
        f"every completed result bitwise its solo run_batch and its drain "
        f"result; fused_walk={counts['fused_walk']} and "
        f"pheromone_update_tours={counts['pheromone_update_tours']} "
        f"launches = {engine_its} engine iterations of the pools, serving "
        f"{slot_counts['fused_walk']} slot-iterations; chunks "
        f"{stats['chunks']}, fills {stats['fills']}; trace ({n_trace} "
        f"events) and event log ({n_events} records) validate")
    log(f"[streaming] streaming: {stats['instances_per_s']:.3f} instances/s, "
        f"latency mean {stats['latency_mean_s']:.3f} s, p95 "
        f"{stats['latency_p95_s']:.3f} s, max {stats['latency_max_s']:.3f} "
        f"s, occupancy mean {stats['occupancy_mean']:.3f} | drain "
        f"(SolverService, max_batch 4, the same {len(reqs)} requests at "
        f"once): {ds['instances_per_s']:.3f} instances/s, wall "
        f"{ds['wall_s']:.2f} s, latency mean {ds['latency_mean_s']:.3f} s, "
        f"p95 {drain_p95:.3f} s, max {ds['latency_max_s']:.3f} s, "
        f"{ds['batches']} jobs")


# The serving CLI's runs: the drain of buckets 512 / 1024 (m = the bucket)
# and the sparse drains of buckets 2048 / 4096 at the route's k and m.
CLI_DENSE = ["--use-pallas", "--variant", "mmas", "--metrics",
             "--num-instances", "6", "--min-n", "500", "--max-n", "1002",
             "--iterations", "6", "--max-batch", "4"]
CLI_STREAM = ["--stream", "--arrival-rate", "20", "--chunk", "2"]
CLI_SPARSE = ["--sparse", "--use-pallas", "--ants", "64", "--sparse-k", "16",
              "--sparse-overflow", "4", "--variant", "mmas",
              "--num-instances", "6", "--min-n", "1500", "--max-n", "2392",
              "--iterations", "10", "--max-batch", "4"]


def _cli_cmd(argv):
    return [sys.executable, "-m", "repro_torch.launch.solve_serve", *argv]


def _check_report(label, rep):
    """A CLI report with every request completed."""
    st = rep["stats"]
    done = st["completed"] if "completed" in st else len(rep["results"])
    want = st["submitted"] if "submitted" in st else st["requests"]
    if rep["schema"] != "repro.solve_serve/v1" or done != want or \
            len(rep["results"]) != want:
        raise AssertionError(f"cli {label}: {done} of {want} requests "
                             "completed")
    return rep


def _cli_main(label, argv):
    """``repro_torch.launch.solve_serve.main()`` in this process with
    ``argv`` and its stdout captured, the launch counts zeroed just before
    the call and read just after -> (report, counts)."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import solve_serve
    out, argv0 = io.StringIO(), sys.argv
    sys.argv = ["solve_serve"] + argv
    try:
        _sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            solve_serve.main()
        _sync()
        secs, counts = time.perf_counter() - t0, ops.launch_counts()
    finally:
        sys.argv = argv0
    rep = _check_report(label, json.loads(out.getvalue()))
    st = rep["stats"]
    log(f"[cli] {label}: main() in {secs:.1f} s; {len(rep['results'])} "
        f"requests, buckets {sorted({r['bucket'] for r in rep['results']})}"
        f": {st['instances_per_s']:.3f} instances/s, latency mean "
        f"{st['latency_mean_s']:.3f} s, max {st['latency_max_s']:.3f} s")
    return rep, counts


def _flag(argv, name, cast=int):
    return cast(argv[argv.index(name) + 1])


def _rows(rep):
    return [(r["id"], r["n"], r["bucket"], r["best_len"], r["iterations"])
            for r in rep["results"]]


def _same_results(label, rep, results):
    """The CLI's rows against an in-process service's results, request by
    request: best length and iterations equal."""
    want = [(r.request_id, r.n, r.bucket, round(r.best_len, 4), r.iterations)
            for r in results]
    if _rows(rep) != want:
        raise AssertionError(f"cli {label}: results differ from the "
                             f"in-process service:\n{_rows(rep)}\n{want}")


def phase_cli(launches: dict) -> None:
    """The serving CLI on the card: its ``main()`` in this process for a
    dense MMAS drain, the same flags streamed, and sparse MMAS drains over
    fp32 and int8 pages, each with every request completed and the kernel
    launches of that run counted (one walk launch per engine iteration);
    the stream's results equal an in-process ``SolverService`` drain of
    its requests; ``python -m repro_torch.launch.solve_serve`` of the fp32
    sparse drain in a subprocess exits 0 with only the JSON report on
    stdout, equal request by request to the in-process run; two refused
    flag sets exit 2 with one line."""
    from repro_torch.core import aco
    from repro_torch.solver import SolverService, make_poisson_trace
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    refused = {label: subprocess.Popen(
        _cli_cmd(argv), cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for label, argv in (
            ("--sparse --shard", CLI_SPARSE + ["--shard"]),
            ("--sparse --stream", CLI_SPARSE + CLI_STREAM))}
    per = _flag(CLI_DENSE, "--max-batch")

    def engine_its(rep, iters):
        """Engine iterations of a drain: one job per bucket and max_batch
        requests, each running every request's whole budget."""
        jobs = {}
        for r in rep["results"]:
            jobs[r["bucket"]] = jobs.get(r["bucket"], 0) + 1
        return sum(-(-c // per) for c in jobs.values()) * iters

    def count(label, counts, kernel, want, entry=None):
        if counts[kernel] != want:
            raise AssertionError(f"cli {label}: {kernel} launched "
                                 f"{counts[kernel]} times, expected {want} "
                                 "(one per engine iteration)")
        entry = entry or kernel
        launches[entry] = launches.get(entry, 0) + counts[kernel]

    # -- dense drain, and the same flags streamed against a drain of the
    # stream's requests
    its = _flag(CLI_DENSE, "--iterations")
    rep, counts = _cli_main("dense drain", CLI_DENSE)
    for kernel in ("fused_walk", "pheromone_update_tours"):
        count("dense drain", counts, kernel, engine_its(rep, its))
    # --shard over the card's one position: the same report per request,
    # the same launches
    shard, counts = _cli_main("dense drain --shard", CLI_DENSE + ["--shard"])
    if _rows(shard) != _rows(rep) or shard["stats"]["devices"] != 1:
        raise AssertionError("cli dense drain --shard: results differ from "
                             f"the unsharded drain:\n{_rows(shard)}\n"
                             f"{_rows(rep)}")
    for kernel in ("fused_walk", "pheromone_update_tours"):
        count("dense drain --shard", counts, kernel, engine_its(rep, its))
    log("[cli] dense drain --shard (one position): every request equal to "
        "the unsharded drain, the same walk and update launches")
    # the dense drain with 2-opt: one two_opt_best launch per round of
    # each job's stack (localsearch.improve counts the stacks' rounds)
    from repro_torch.core import localsearch
    localsearch.improve.rounds = 0
    rep, counts = _cli_main("dense drain 2opt",
                            CLI_DENSE + ["--local-search", "2opt"])
    rounds = localsearch.improve.rounds
    count("dense drain 2opt", counts, "fused_walk", engine_its(rep, its))
    if rounds == 0 or counts["two_opt_best"] != rounds:
        raise AssertionError(f"cli dense drain 2opt: two_opt_best launched "
                             f"{counts['two_opt_best']} times for {rounds} "
                             "rounds of the stacks")
    launches["two_opt_best"] = launches.get("two_opt_best", 0) + rounds
    launches["pheromone_update_tours"] += counts["pheromone_update_tours"]
    log(f"[cli] dense drain 2opt: fused_walk={counts['fused_walk']} = engine "
        f"iterations, two_opt_best={counts['two_opt_best']} = the stacks' "
        f"local-search rounds; best "
        + ", ".join(f"{r['best_len']:.1f}" for r in rep["results"]))
    rep, counts = _cli_main("dense stream", CLI_DENSE + CLI_STREAM)
    for kernel in ("fused_walk", "pheromone_update_tours"):
        if counts[kernel] == 0:
            raise AssertionError(f"cli dense stream: no {kernel} launch")
        launches[kernel] += counts[kernel]
    trace = make_poisson_trace(_flag(CLI_DENSE, "--num-instances"),
                               _flag(CLI_STREAM, "--arrival-rate", float),
                               _flag(CLI_DENSE, "--min-n"),
                               _flag(CLI_DENSE, "--max-n"), seed=0,
                               iterations=its)
    svc = SolverService(aco.ACOConfig(variant="mmas", use_pallas=True,
                                      metrics=True, iterations=its),
                        max_batch=per, device=DEV)
    for it in trace:
        svc.submit(it.instance, iterations=it.iterations, seed=it.seed)
    _same_results("dense stream (against the drain of its requests)", rep,
                  svc.run())
    # -- sparse drains, fp32 and int8 pages
    sits = _flag(CLI_SPARSE, "--iterations")
    sparse = {}
    for label, extra, entry in (("sparse drain", [], "sparse_walk"),
                                ("sparse drain int8",
                                 ["--tau-dtype", "int8"],
                                 "sparse_walk_quant_int8")):
        sparse[label], counts = _cli_main(label, CLI_SPARSE + extra)
        count(label, counts, "sparse_walk", engine_its(sparse[label], sits),
              entry)
    # -- the command itself: exit 0, stdout only the JSON report
    t0 = time.perf_counter()
    p = subprocess.run(_cli_cmd(CLI_SPARSE), cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise AssertionError(f"cli sparse drain: exit {p.returncode}\n"
                             f"{p.stderr[-4000:]}")
    rep = _check_report("sparse drain (python -m)", json.loads(p.stdout))
    if _rows(rep) != _rows(sparse["sparse drain"]):
        raise AssertionError("cli sparse drain: python -m's results differ "
                             "from main() in process")
    log(f"[cli] python -m repro_torch.launch.solve_serve (sparse drain): "
        f"exit 0 in {time.perf_counter() - t0:.1f} s (process included), "
        f"stdout only the JSON report; every request equal to main() in "
        f"process")
    for label, proc in refused.items():
        out, err = proc.communicate(timeout=300)
        lines = err.strip().splitlines()
        if proc.returncode != 2 or out or len(lines) != 1 or \
                not lines[0].startswith("solve_serve: "):
            raise AssertionError(f"cli {label}: exit {proc.returncode}, "
                                 f"stderr {err[-2000:]!r}")
        log(f"[cli] {label}: exit 2, one line: {lines[0][:120]}")


# [mesh]: the island model, the city-sharded colony and the instance-sharded
# engine and services over meshes whose positions repeat the one card.
MESH_N = 1002                  # pr1002's size, m = n ants
MESH_ISLANDS, MESH_EVERY, MESH_ROUNDS = 4, 2, 2
MESH_SLABS = 3                 # 1002 % 3 == 0: (1002, 334) column slabs
MESH_SMALL_ISL_N = 100         # card == CPU, 4 islands
MESH_SMALL_SC_N, MESH_SMALL_SC_S = 96, 4   # card == CPU, sharded colony
MESH_SERVICE_NS = (613, 801, 1002, 700, 900)


def _mesh_of(shape, names, dev=None):
    """A mesh of ``shape`` whose every position is ``dev`` (the card by
    default)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh
    if dev is None:
        dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device(DEV)
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [dev] * devs.size
    return Mesh(devs.reshape(shape), names)


def _timed(fn):
    """(result, wall seconds) of ``fn()`` between two synchronisations."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _mesh_islands(launches: dict) -> None:
    """Four islands on one card at n = m = 1002, two rounds of two
    iterations, with and without 2-opt polish; one fused_walk and one
    pheromone_update_tours launch per island iteration; a round and its
    exchange timed beside four solo colonies; four islands at n = 100 on
    the card equal to the same islands on the CPU."""
    import torch
    from repro_torch import tree
    from repro_torch.core import aco, collectives, islands, tsp
    from repro_torch.kernels import ops
    mesh = _mesh_of((MESH_ISLANDS,), ("data",))
    inst = tsp.random_instance(MESH_N, seed=7)
    its = MESH_EVERY * MESH_ROUNDS
    for label, kw in (("plain", {}),
                      ("2-opt polish", dict(local_search="2opt",
                                            ls_tours="iteration_best"))):
        cfg = islands.IslandConfig(
            aco=aco.ACOConfig(variant="mmas", use_pallas=True, **kw),
            exchange_every=MESH_EVERY, rounds=MESH_ROUNDS, mix_lambda=0.1)
        _sync()
        ops.reset_launch_counts()
        st, secs = _timed(lambda: islands.run_islands(inst, cfg, mesh))
        counts = ops.launch_counts()
        want = {"fused_walk": MESH_ISLANDS * its,
                "pheromone_update_tours": MESH_ISLANDS * its}
        if kw:
            if counts["two_opt_best"] < 1:
                raise AssertionError("mesh islands 2-opt: no two_opt_best "
                                     "launch")
            want["two_opt_best"] = counts["two_opt_best"]
        _check_counts(f"mesh islands {label}", counts, want)
        for k in want:
            launches[k] = launches.get(k, 0) + counts[k]
        best, c_nn = _check_run(f"mesh islands {label}", tree.index(
            st, int(torch.argmin(st.best_len))), inst, MESH_N, 1.3)
        ratio = best / c_nn
        if not torch.isfinite(st.tau).all():
            raise AssertionError(f"mesh islands {label}: tau not finite")
        log(f"[mesh] islands {label}: {MESH_ISLANDS} islands on one card, "
            f"MMAS n=m={MESH_N}, {MESH_ROUNDS} rounds x {MESH_EVERY} "
            f"iterations: {secs:.3f} s; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
            + f"; global best {best:.1f} ({ratio:.3f} x NN tour), islands' "
            f"best " + " ".join(f"{float(b):.1f}" for b in st.best_len))

    # one round (exchange_every iterations + the exchange) beside the same
    # iterations of four solo colonies, set-up excluded, and the exchange
    # alone
    dev0 = mesh.device_list()[0]
    for label, kw in (("plain", {}),
                      ("2-opt polish", dict(local_search="2opt",
                                            ls_tours="iteration_best"))):
        acfg = aco.ACOConfig(variant="mmas", use_pallas=True, **kw)
        cfg = islands.IslandConfig(aco=acfg, exchange_every=MESH_EVERY,
                                   rounds=1, mix_lambda=0.1)
        probs = [aco.make_problem(inst, acfg.nn_k, dev0)] * MESH_ISLANDS
        first = islands.scatter_islands(islands.init_island_states(
            inst, cfg, MESH_ISLANDS, device=dev0), mesh.device_list())

        def solo():
            return [aco.run_scan(p, s, acfg, MESH_EVERY)[0]
                    for p, s in zip(probs, first)]

        def one_round():
            return islands._exchange(solo(), probs, cfg, "data", mesh)
        one_round()                                                # warm
        _, round_s = _timed(one_round)
        states, solo_s = _timed(solo)
        _, ex_s = _timed(lambda: islands._exchange(states, probs, cfg,
                                                   "data", mesh))
        _, pm_s = _timed(lambda: collectives.pmean(
            [s.tau for s in states], "data", mesh))
        log(f"[mesh] one island round, {label}: {MESH_ISLANDS} islands x "
            f"{MESH_EVERY} iterations + exchange {round_s * 1e3:.1f} ms | "
            f"{MESH_ISLANDS} solo colonies x {MESH_EVERY} iterations "
            f"{solo_s * 1e3:.1f} ms | ratio {round_s / solo_s:.3f} | the "
            f"exchange alone (ring, polish, deposit, pmean, mix) "
            f"{ex_s * 1e3:.2f} ms, of which pmean of {MESH_ISLANDS} (n, n) "
            f"tau {pm_s * 1e3:.2f} ms")

    # card == CPU at n = 100
    small = tsp.random_instance(MESH_SMALL_ISL_N, seed=3)
    cfg = islands.IslandConfig(
        aco=aco.ACOConfig(variant="as", rho=0.1, use_pallas=True,
                          local_search="2opt", ls_tours="iteration_best"),
        exchange_every=2, rounds=2, mix_lambda=0.1)
    card = islands.run_islands(small, cfg, mesh)
    cpu = islands.run_islands(small, cfg, _mesh_of((MESH_ISLANDS,),
                                                   ("data",), "cpu"))
    for f in ("best_tour", "best_len", "iteration", "key"):
        if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"mesh islands n={MESH_SMALL_ISL_N}: {f} "
                                 "card != CPU")
    torch.testing.assert_close(card.tau.cpu(), cpu.tau, rtol=1e-5,
                               atol=1e-7)
    log(f"[mesh] islands n={MESH_SMALL_ISL_N}, AS + 2-opt polish, 4 "
        f"islands: card == CPU (tours, lengths, keys bitwise; tau max abs "
        f"diff {float((card.tau.cpu() - cpu.tau).abs().max()):.3e})")


def _slab_stream(n, s, m, seed):
    """A (n, n/s) slab's deposit operands as the sharded step builds them:
    the edge stream of m random tours, ``to`` in slab 1's column frame and
    -1 outside it (slab 0 when s = 1)."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV
    nl = n // s
    c0 = nl if s > 1 else 0
    tours = torch.stack([torch.randperm(n, generator=gen, device=dev)
                         for _ in range(m)]).to(torch.int32)
    frm = tours.reshape(-1)
    to = torch.roll(tours, -1, dims=-1).reshape(-1)
    lens = torch.rand(m, generator=gen, device=dev) * 1e3 + 1e3
    wrep = torch.repeat_interleave(1.0 / lens, n)
    f2, t2 = torch.cat([frm, to]), torch.cat([to, frm]) - c0
    t2 = torch.where((t2 >= 0) & (t2 < nl), t2, torch.full_like(t2, -1))
    tau = torch.rand((n, nl), generator=gen, device=dev) * 1e-3 + 1e-4
    return tau, f2, t2, torch.cat([wrep, wrep])


def _mesh_sharded_colony(launches: dict, results: dict) -> None:
    """The city-sharded colony on one card at n = m = 1002: S = 3 column
    slabs, the edge-stream pheromone_update launched once per slab and
    iteration; a (2, 3) mesh with the ants split over ``data``; one
    iteration at S = 3 beside S = 1; the edge-stream kernel on a (1002,
    334) slab against its plain version, timed with its bound; the colony
    at n = 96, S = 4 on the card equal to the CPU's."""
    import torch
    from repro_torch.core import aco, islands, tsp
    from repro_torch.kernels import ops
    from repro_torch.kernels import pheromone_update as pu
    inst = tsp.random_instance(MESH_N, seed=11)
    cfg = aco.ACOConfig(use_pallas=True, seed=2)
    iters = {}
    for label, shape, ants, n_it in (("S=3", (1, MESH_SLABS), None, 2),
                                     ("(2, 3) ants over data",
                                      (2, MESH_SLABS), "data", 1)):
        mesh = _mesh_of(shape, ("data", "model"))
        _sync()
        ops.reset_launch_counts()
        st, secs = _timed(lambda: islands.run_sharded_colony(
            inst, cfg, mesh, iterations=n_it, ants_axis=ants))
        counts = ops.launch_counts()
        _check_counts(f"mesh sharded colony {label}", counts,
                      {"pheromone_update": mesh.size * n_it})
        launches["pheromone_update"] = launches.get("pheromone_update", 0) \
            + counts["pheromone_update"]
        best, c_nn = _check_run(f"mesh sharded colony {label}", st, inst,
                                MESH_N, 1.3)
        ratio = best / c_nn
        for t in st.tau:
            if not torch.isfinite(t).all():
                raise AssertionError(f"mesh sharded colony {label}: tau not "
                                     "finite")
        iters[label] = secs / n_it
        log(f"[mesh] sharded colony {label}: AS n=m={MESH_N}, {n_it} "
            f"iterations over {mesh.size} positions of one card: "
            f"{secs:.2f} s; pheromone_update (edge stream, ({MESH_N}, "
            f"{MESH_N // MESH_SLABS}) slabs) launched "
            f"{counts['pheromone_update']} times; best "
            f"{float(st.best_len):.1f} ({ratio:.3f} x NN tour)")
    one = _mesh_of((1, 1), ("data", "model"))
    _, s1 = _timed(lambda: islands.run_sharded_colony(inst, cfg, one,
                                                      iterations=1))
    log(f"[mesh] sharded colony, one iteration: S=3 {iters['S=3']:.2f} s "
        f"| S=1 {s1:.2f} s | ratio {iters['S=3'] / s1:.3f}")

    # the edge-stream kernel on the slab shape the S = 3 step launches it
    # at, against its plain version (atomic order: rtol 1e-5 / atol 1e-7)
    n, nl = MESH_N, MESH_N // MESH_SLABS
    tau, f2, t2, w2 = _slab_stream(n, MESH_SLABS, n, 5)
    got = pu.pheromone_update(tau, f2, t2, w2, 0.5)
    want = pu.pheromone_update_plain(tau, f2, t2, w2, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    err = float((got - want).abs().max())
    valid = t2 >= 0
    flat = (f2[valid].long() * nl + t2[valid].long())
    wv = w2[valid]
    n_valid = int(valid.sum())

    def library():
        return (tau * 0.5).view(-1).index_add_(0, flat, wv)
    ms = device_ms(lambda: pu.pheromone_update(tau, f2, t2, w2, 0.5))
    wall = cuda_ms(lambda: pu.pheromone_update(tau, f2, t2, w2, 0.5))
    plain_ms = device_ms(lambda: pu.pheromone_update_plain(tau, f2, t2, w2,
                                                           0.5))
    lib_split = device_split(library)
    lib_ms = sum(lib_split.values()) / 1e3 or device_ms(library)
    lib_wall = cuda_ms(library)
    # each input read once, the slab written once: tau and out, the whole
    # stream (frm, to, w); the work this data needs: one multiply a cell
    # and one add per edge that lands in the slab
    nbytes = n * nl * 8 + f2.numel() * 12
    b_ms, b_by = bound(nbytes, n * nl + n_valid)
    results["pheromone_update"] = {
        "max_abs_err": err, "ms": wall if ms is None else ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}
    log(f"[mesh] pheromone_update (edge stream) on a ({n}, {nl}) slab, "
        f"E={f2.numel()} edges ({n_valid} in the slab): device "
        f"{(wall if ms is None else ms) * 1e3:.2f} us, per call "
        f"{wall * 1e3:.1f} us | plain device {plain_ms * 1e3:.1f} us | "
        f"library (mul + index_add_ of the slab's edges) device "
        f"{lib_ms * 1e3:.1f} us ("
        + ", ".join(f"{k[:40]} {v:.1f}" for k, v in lib_split.items())
        + f"), per call {lib_wall * 1e3:.1f} us | bound {b_ms * 1e3:.2f} "
        f"us by {b_by} "
        f"({nbytes / 1e6:.1f} MB) | max abs err {err:.3e}")

    # card == CPU at n = 96 over S = 4 slabs: the kernel route on the card
    # against the plain versions on the CPU, two iterations
    small = tsp.random_instance(MESH_SMALL_SC_N, seed=4)
    scfg = aco.ACOConfig(use_pallas=True, rho=0.1, seed=6)
    shape = (1, MESH_SMALL_SC_S)
    card = islands.run_sharded_colony(small, scfg,
                                      _mesh_of(shape, ("data", "model")),
                                      iterations=2)
    cmesh = _mesh_of(shape, ("data", "model"), "cpu")
    cpu = islands.run_sharded_colony(small, scfg, cmesh, iterations=2)
    for f in ("best_tour", "best_len", "iteration", "key"):
        if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"mesh sharded colony n={MESH_SMALL_SC_N}: "
                                 f"{f} card != CPU")
    tc = islands.unshard_columns([t.cpu() for t in card.tau], cmesh)
    tp = islands.unshard_columns(cpu.tau, cmesh)
    torch.testing.assert_close(tc, tp, rtol=1e-5, atol=1e-7)
    log(f"[mesh] sharded colony n={MESH_SMALL_SC_N}, S={MESH_SMALL_SC_S}, "
        f"2 iterations: card (edge-stream kernel) == CPU (plain): tours, "
        f"lengths, keys bitwise, tau max abs diff "
        f"{float((tc - tp).abs().max()):.3e} (rtol 1e-5 / atol 1e-7)")


def _mesh_placement(launches: dict) -> None:
    """run_batch over a 4-position mesh of the card on the [batched]
    bucket (four MMAS slots, bucket 1024) bitwise the unsharded run per
    slot, timed beside it; both services over a 4-position mesh bitwise
    their unsharded runs."""
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    from repro_torch.solver import batch, engine, service, streaming
    mesh = _mesh_of((4,), ("data",))
    insts = [tsp.random_instance(n, seed=n) for n in BATCH_NS]
    budgets = list(BATCH_BUDGETS)
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True,
                        iterations=max(budgets))
    b = batch.make_batch(insts, BATCH_PAD, cfg.nn_k, device=DEV)

    def run(m):
        st = engine.init_states(insts, cfg, BATCH_SEEDS, BATCH_PAD,
                                device=DEV)
        _sync()
        return _timed(lambda: engine.run_batch(
            b.problem, st, budgets, cfg, max(budgets), donate=True,
            mesh=m)[0])
    run(None)
    run(mesh)                                                      # warm
    ops.reset_launch_counts()
    sharded, sh_s = run(mesh)
    counts = ops.launch_counts()
    plain, pl_s = run(None)
    # one shard a slot: each slot's own budget of walks and updates
    _check_counts("mesh run_batch", counts,
                  {"fused_walk": sum(budgets),
                   "pheromone_update_tours": sum(budgets)})
    for k in ("fused_walk", "pheromone_update_tours"):
        launches[k] = launches.get(k, 0) + counts[k]
    if not _leaves_equal(sharded, plain):
        raise AssertionError("mesh run_batch: sharded != unsharded")
    sharded2, sh2_s = run(mesh)
    plain2, pl2_s = run(None)
    # device busy time of each call (torch.profiler, one call)
    busy = {tag: sum(device_split(lambda m=m: run(m), reps=1).values())
            / 1e3 for tag, m in (("sharded", mesh), ("unsharded", None))}
    log(f"[mesh] run_batch over 4 positions of one card, MMAS bucket "
        f"{BATCH_PAD}, n={list(BATCH_NS)}, budgets {budgets}: bitwise the "
        f"unsharded run in every slot; fused_walk={counts['fused_walk']} "
        f"launches (one shard a slot); wall sharded {sh_s * 1e3:.1f} / "
        f"{sh2_s * 1e3:.1f} ms, unsharded {pl_s * 1e3:.1f} / "
        f"{pl2_s * 1e3:.1f} ms, ratio {sh_s / pl_s:.3f} / "
        f"{sh2_s / pl2_s:.3f}; device busy sharded {busy['sharded']:.1f} "
        f"ms (idle share {1 - busy['sharded'] / sh2_s / 1e3:.3f}), "
        f"unsharded {busy['unsharded']:.1f} ms (idle share "
        f"{1 - busy['unsharded'] / pl2_s / 1e3:.3f})")

    # both services over the mesh against their unsharded runs
    reqs = [tsp.random_instance(n, seed=200 + i)
            for i, n in enumerate(MESH_SERVICE_NS)]
    scfg = aco.ACOConfig(variant="mmas", use_pallas=True, metrics=True,
                         iterations=3)
    out = {}
    for tag, m in (("mesh", mesh), ("one", None)):
        svc = service.SolverService(scfg, max_batch=4, device=DEV, mesh=m)
        for i, inst in enumerate(reqs):
            svc.submit(inst, iterations=2 + i % 2, seed=i)
        ops.reset_launch_counts()
        out[tag] = svc.run()
        if tag == "mesh":
            c = ops.launch_counts()
            launches["fused_walk"] += c["fused_walk"]
            launches["pheromone_update_tours"] += c["pheromone_update_tours"]
            if svc.stats["devices"] != 4:
                raise AssertionError("mesh service: devices != 4")
        st = streaming.StreamingSolverService(scfg, max_batch=2, chunk=2,
                                              device=DEV, mesh=m)
        for i, inst in enumerate(reqs):
            st.submit(inst, iterations=2 + i % 2, seed=i)
        out["stream_" + tag] = sorted(st.run_until_drained(),
                                      key=lambda r: r.request_id)
        if tag == "mesh" and st.stats["pools"] < 2:
            raise AssertionError(f"mesh streaming: {st.stats['pools']} "
                                 "pools")
    for a_tag, b_tag in (("mesh", "one"), ("stream_mesh", "stream_one")):
        for x, y in zip(out[a_tag], out[b_tag]):
            if (x.request_id, x.best_len, x.iterations) != \
                    (y.request_id, y.best_len, y.iterations) or \
                    not (x.best_tour == y.best_tour).all() or \
                    x.metrics != y.metrics:
                raise AssertionError(f"mesh {a_tag}: request "
                                     f"{x.request_id} != unsharded")
    log(f"[mesh] SolverService and StreamingSolverService over 4 positions "
        f"of one card ({len(reqs)} MMAS requests, n {list(MESH_SERVICE_NS)}"
        f"): every result "
        f"bitwise the unsharded service's (tour, length, iterations, "
        f"metrics row)")


def phase_mesh(launches: dict, results: dict) -> None:
    """[mesh]: ROADMAP item 14 on one card, positions repeating it."""
    t0 = time.perf_counter()
    _mesh_islands(launches)
    _mesh_sharded_colony(launches, results)
    _mesh_placement(launches)
    log(f"[mesh] phase wall {time.perf_counter() - t0:.1f} s")


def phase_sparse_split() -> None:
    """Where one sparse MMAS iteration over an int8 store goes at
    n = 2392, k = 16, m = 64 (host clock between synchronisations, median
    of three): construction, the update with adoption (and the clamp), and
    requantise, beside the whole iteration; then one ``torch.profiler``
    pass of an fp32 MMAS data-parallel iteration: device busy time, idle
    share and the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import aco, quant, sampling, tsp
    from repro_torch.sparse import aco as sa, construct, pheromone, store
    n, m, k = SPARSE_N, SPARSE_M, SPARSE_K
    inst = tsp.random_instance(n, seed=n)
    cfg = aco.ACOConfig(variant="mmas", tau_dtype="int8", sparse=True,
                        sparse_k=k, m=m, use_pallas=True, seed=1)
    prob = store.make_sparse_problem(inst, k, device="cuda")
    state = sa.init_sparse_colony(inst, cfg, device="cuda")
    state, _ = sa.sparse_colony_step(prob, state, cfg, "RAW")      # warm

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    _, k_tour, k_q = sampling.split(state.key, 3)
    k_q1, k_q2 = sampling.split(k_q)
    tau_f = quant.dequantise(state.tau)
    ovf_f = quant.dequantise(state.ovf_tau)
    it_ms, con_ms, upd_ms, rq_ms = [], [], [], []
    for _ in range(3):
        it_ms.append(timed(lambda: sa.sparse_colony_step(
            prob, state, cfg, "RAW"))[1])
        res, ms = timed(lambda: construct.construct_sparse_tours(
            k_tour, prob, state.tau, state.ovf_city, state.ovf_tau, m,
            "iroulette", 1.0, 2.0, "RAW", use_pallas=True))
        con_ms.append(ms)
        ib = torch.argmin(res.lengths)
        w = (1.0 / res.lengths[ib])[None]

        def update():
            out = pheromone.update_sparse(
                quant.dequantise(state.tau), state.tau_def, state.ovf_city,
                quant.dequantise(state.ovf_tau), prob.cand,
                res.tours[ib][None, :], w, cfg.rho, True)
            lo, hi = aco.mmas_bounds(res.lengths[ib], cfg, n, None)
            return [torch.clamp(t, min=lo, max=hi) for t in
                    (out[0], out[1], out[3])]

        upd_ms.append(timed(update)[1])
        rq_ms.append(timed(lambda: (
            quant.requantise(tau_f, state.tau, "int8", k_q1),
            quant.requantise(ovf_f, state.ovf_tau, "int8", k_q2)))[1])
    med = statistics.median
    log(f"[split] sparse MMAS int8, n={n} k={k}+4 m={m}, one iteration "
        f"(median of 3): {med(it_ms):.1f} ms; construction "
        f"{med(con_ms):.1f} ms ({n - 1} steps, "
        f"{med(con_ms) / (n - 1) * 1e3:.0f} us each), update with adoption "
        f"{med(upd_ms):.2f} ms, requantise {med(rq_ms):.2f} ms")

    cfg = aco.ACOConfig(variant="mmas", sparse=True, sparse_k=k, m=m,
                        use_pallas=True, seed=1)
    state = sa.init_sparse_colony(inst, cfg, device="cuda")
    state, _ = sa.sparse_colony_step(prob, state, cfg, "RAW")      # warm
    _, wall_ms = timed(lambda: sa.sparse_colony_step(prob, state, cfg,
                                                     "RAW"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sa.sparse_colony_step(prob, state, cfg, "RAW")
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0:
            per_name[e.key] = (per_name.get(e.key, (0.0, 0))[0] + us,
                               e.count)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    log(f"[profile] sparse MMAS n={n} k={k}+4 m={m}, one iteration: wall "
        f"{wall_ms:.1f} ms (no profiler), device busy {busy_ms:.1f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, count) in top:
        log(f"[profile]   {us / 1e3:8.2f} ms  {count:6d} launches  "
            f"{name[:90]}")


def phase_profile() -> None:
    """Where one AS iteration at n = m = 1002 spends the card's time: the
    device busy time (``torch.profiler``) against the iteration's wall
    time without the profiler, and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import aco, tsp
    inst = tsp.random_instance(1002)
    cfg = aco.ACOConfig(use_pallas=True, iterations=1, seed=1)
    prob = aco.make_problem(inst, cfg.nn_k, "cuda")
    state = aco.init_colony(inst, cfg, device="cuda")
    state, _ = aco.colony_step(prob, state, cfg)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = aco.colony_step(prob, state, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        aco.colony_step(prob, state, cfg)
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if us > 0:
            per_name[e.key] = (per_name.get(e.key, (0.0, 0))[0] + us,
                               e.count)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    log(f"[profile] AS n=m=1002, one iteration: wall {wall_ms:.1f} ms "
        f"(no profiler), device busy {busy_ms:.1f} ms, device idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, count) in top:
        log(f"[profile]   {us / 1e3:8.2f} ms  {count:6d} launches  "
            f"{name[:90]}")


def phase_split() -> None:
    """Where one MMAS + 2-opt iteration over an int8 store goes at
    n = m = 1002: its construction (the quantised fused step), its local
    search and its update + requantise (the extra stochastic draw), each
    on the host clock between synchronisations, beside the whole
    iteration."""
    import torch
    from repro_torch.core import (aco, localsearch, quant, sampling,
                                  strategies, tsp)
    inst = tsp.random_instance(1002)
    cfg = aco.ACOConfig(variant="mmas", local_search="2opt", tau_dtype="int8",
                        use_pallas=True, seed=1)
    prob = aco.make_problem(inst, cfg.nn_k, "cuda")
    state = aco.init_colony(inst, cfg, device="cuda")
    state, _ = aco.colony_step(prob, state, cfg)          # warm

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    _, k_tour, k_q = sampling.split(state.key, 3)
    tau_f = quant.dequantise(state.tau)
    # three rounds of (iteration, its parts); medians, as the host's clock
    # varies from call to call on a shared machine
    it_ms, con_ms, ls_ms, rq_ms, rounds = [], [], [], [], []
    for _ in range(3):
        it_ms.append(timed(lambda: aco.colony_step(prob, state, cfg))[1])
        res, ms = timed(lambda: strategies.construct_tours(
            k_tour, prob.dist, None, 1002, method="fused", tau=state.tau.q,
            eta=prob.eta, tau_scale=state.tau.scale))
        con_ms.append(ms)
        localsearch.improve.rounds = 0
        ls_ms.append(timed(lambda: aco.polish_tours(prob, res.tours, cfg))[1])
        rounds.append(localsearch.improve.rounds)
        rq_ms.append(timed(lambda: quant.requantise(tau_f, state.tau, "int8",
                                                    k_q))[1])
    med = statistics.median
    log(f"[split] MMAS + 2opt, int8 tau, n=m=1002, one iteration (median of "
        f"3): {med(it_ms):.1f} ms; construction {med(con_ms):.1f} ms, local "
        f"search {med(ls_ms):.1f} ms ({med(rounds)} rounds, "
        f"{med(ls_ms) / max(med(rounds), 1):.2f} ms each), requantise "
        f"{med(rq_ms):.2f} ms")


def phase_solo_launches() -> None:
    """The device operations of one solo sparse MMAS iteration (n = 2392,
    k = 16 + 4, m = 64, fp32 and int8 pages) from ``torch.profiler``:
    every kernel and copy launched, the busiest elementwise kind's
    launches, and the three kinds launched most.  The counts depend on the
    code path only, not on the machine's load."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import aco, tsp
    from repro_torch.sparse import aco as sa, store
    inst = tsp.random_instance(SPARSE_N, seed=SPARSE_N)
    prob = store.make_sparse_problem(inst, SPARSE_K, device="cuda")
    for dtype in ("fp32", "int8"):
        cfg = aco.ACOConfig(variant="mmas", tau_dtype=dtype, sparse=True,
                            sparse_k=SPARSE_K, m=SPARSE_M, use_pallas=True,
                            seed=1)
        state = sa.init_sparse_colony(inst, cfg, device="cuda")
        state, _ = sa.sparse_colony_step(prob, state, cfg, "RAW")  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sa.sparse_colony_step(prob, state, cfg, "RAW")
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) or 0)
            if us > 0:
                kinds[e.key] = kinds.get(e.key, 0) + e.count
        elementwise = {k: v for k, v in kinds.items() if "elementwise" in k}
        busiest = max(elementwise.values()) if elementwise else 0
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:3]
        log(f"[solo-launches] sparse MMAS {dtype} n={SPARSE_N} "
            f"k={SPARSE_K}+4 m={SPARSE_M}, one iteration: "
            f"{sum(kinds.values())} device operations of {len(kinds)} "
            f"kinds; busiest elementwise kind {busiest} launches; most: "
            + "; ".join(f"{v} x {k[:60]}" for k, v in top))


_SOLO = """
import importlib.util, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = load("smoke", os.path.join(root, "chip_smoke.py"))
smoke.phase_device()
smoke.phase_build()
smoke.phase_main({})
smoke.phase_profile()
smoke.phase_split()
smoke.phase_sparse_split()
load("counter", sys.argv[2]).phase_solo_launches()
"""


def solo(roots) -> int:
    """The solo paths' timing phases of each checkout in ``roots``, each
    in its own process (its own ``repro_torch`` and kernel build), then
    this script's count of one solo sparse iteration's device operations
    on that checkout's package."""
    for root in roots:
        log(f"[solo] {os.path.abspath(root)}")
        subprocess.run([sys.executable, "-c", _SOLO, os.path.abspath(root),
                        os.path.abspath(__file__)],
                       check=True, cwd=root, timeout=600)
    return 0


def main() -> int:
    import torch   # noqa: F401  (fails here when torch is absent)
    if sys.argv[1:2] == ["--solo"]:
        return solo(sys.argv[2:])
    root = os.path.dirname(os.path.abspath(__file__))
    smi = phase_device()
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_dense_walk(results)
    phase_sparse_kernels(results)
    phase_small()
    phase_small_sparse()
    launches: dict = {}
    phase_main(launches)
    phase_sparse(launches)
    phase_batched(launches)
    phase_service(launches)
    phase_streaming(launches)
    phase_cli(launches)
    phase_mesh(launches, results)
    phase_profile()
    phase_split()
    phase_sparse_split()
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        n_launch = launches.get(name, 0)
        if name in SUPERSEDED:
            if n_launch:
                raise AssertionError(f"kernel {name} was launched on a path "
                                     f"where {SUPERSEDED[name]} replaces it")
        elif n_launch == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": n_launch, **results[name]}
        if name in SUPERSEDED:
            entry["superseded_by"] = SUPERSEDED[name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
