#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

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
   counter draws (whole walks, and a walk's last 400 steps), a padded
   instance and Partial-ACO windows; timed per
   launch beside the plain walk and the per-step loop it replaced;
4. small   -- the one-rounding multiply-add (``torch.addcmul``) and the
   per-step draw on the card against the CPU, bitwise; small colonies on
   the card's kernel route (plain MMAS and AS, MMAS + 2-opt/Or-opt, MMAS
   over a stochastic int8 store; sparse MMAS, sparse Partial-ACO and
   sparse MMAS over int8 pages with k = 4 + 4 overflow slots, where
   adoption, eviction and the page-fault fallback occur) against the same
   colonies on the CPU (plain versions), and no worse than the
   nearest-neighbour tour;
5. main    -- ``aco.run`` at n = m = 1002: AS, MMAS and ACS on the fused
   kernel route, AS on ``construction="pallas"``, MMAS + 2-opt, ACS +
   2-opt/Or-opt (first improvement, every 2nd iteration), MMAS over an
   int8 store and AS over a bf16 store; one AS iteration at n = m = 2392
   (the paper's pr2392).  Launch counts are zeroed before each run and
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
6. profile -- device busy time and idle share of one AS iteration at
   n = 1002, and the kernels that take most of it; the split of one MMAS
   + 2-opt iteration over an int8 store into construction, local search
   and update + requantise; the split of one sparse MMAS int8 iteration
   at n = 2392 and the profile of a sparse fp32 one;
7. one JSON line listing every kernel, then the card's ``nvidia-smi``
   line, then the last line ``{"ok": true, "device": {...}}``.  The
   edge-stream K2 and the one-step K7 keep the reference kernels' own
   signatures and are checked and timed, but no path launches them any
   more: their entries report 0 launches and name the kernel that took
   their place (``superseded_by``).

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
}
# Launchers that keep the reference kernel's own signature and are checked
# and timed here, but that no path of the port launches any more: the
# kernel that took their place on the path.
SUPERSEDED = {
    "pheromone_update": "pheromone_update_tours",
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


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median over trials of the mean time of ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(3):
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


def device_ms(fn, reps: int = 10):
    """Device time per call (ms): the sum of the kernels' own durations
    that ``torch.profiler`` records over ``reps`` calls, or None where it
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        total_us += (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    return total_us / reps / 1e3 if total_us > 0 else None


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work on the card (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
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
    both draws (whole walks and each walk's last 400 steps), a padded
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
    # city visited but 400: the walk's last 400 steps, where the fallback
    # is taken most) to keep the plain walks' time in bounds; greedy draws
    # nothing, so it runs under one draw mode; Partial-ACO's own window 64
    grid = [("fp32", "iroulette", "packed", None, None),
            ("fp32", "gumbel", "counter", None, None),
            ("fp32", "iroulette", "packed", n + 7, None)]
    grid += [(dtype, mode, draw, None, 400) for dtype in ("fp32",) + QUANT
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
        f"iroulette packed, gumbel counter, padded n={n + 7}; the last 400 "
        f"steps: fp32, int8, bf16 x iroulette, gumbel x packed, counter and "
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
        fb = int(kern()[2].sum())
        wall = cuda_ms(kern, reps=3, trials=3)
        # the walk kernel's own entry in three one-call profiles (the
        # tabu-row copy of each call excluded), median
        own = [sum(us for name, us in device_split(kern, reps=1).items()
                   if "sparse_walk_kernel" in name) for _ in range(3)]
        ms = statistics.median(own) / 1e3 if min(own) > 0 else wall
        plain_wall = cuda_ms(lambda: _walk(ss.sparse_walk_plain, operands,
                                           "iroulette", "packed", ewt, None),
                             reps=1, trials=1)
        loop_wall = cuda_ms(lambda: _walk(k7_loop, operands, "iroulette",
                                          "packed", ewt, None),
                            reps=1, trials=1) if dtype == "fp32" else None
        # bytes, each input read once and each output written once: the
        # problem and page stores (coordinates, ids, distances, eta, the
        # payloads with their int8 row scales, overflow ids), the tabu rows
        # in and out, keys and start, the cities, lengths and fallbacks;
        # operations: the float work at each visited page position
        tau_b = ss._payload(tau)[0].element_size()
        nbytes = (n * 8 + n * k * 12 + n * (k + o) * tau_b + n * o * 4
                  + (8 * n if dtype == "int8" else 0) + 2 * m * n
                  + steps * 16 + m * 4 + steps * m * 8 + m * 4)
        b_ms, b_by = bound(nbytes, steps * m * (k + o) * 8)
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
            f"MB); latency floor {steps} dependent steps | library: none")


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
            ("mmas", dict(variant="mmas"), 10, True, ("fused_select",)),
            ("as", dict(variant="as"), 1, True, ("fused_select",)),
            ("mmas + 2opt_oropt", dict(variant="mmas",
                                       local_search="2opt_oropt"), 3, True,
             ("fused_select", "two_opt_best")),
            ("mmas + int8 stochastic", dict(variant="mmas", tau_dtype="int8",
                                            tau_round="stochastic"), 10, True,
             ("fused_select_quant",))):
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
    dense = {"fused_select": 1001, "pheromone_update_tours": 1}
    quantised = {"fused_select_quant": 1001, "pheromone_update_tours": 1}
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
        ("as", 2392, dict(variant="as", iterations=1),
         {"fused_select": 2391, "pheromone_update_tours": 1}, 1.2, None),
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
            name = k if k != "fused_select_quant" else \
                f"fused_select_quant_{cfg.tau_dtype}"
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


def main() -> int:
    import torch   # noqa: F401  (fails here when torch is absent)
    root = os.path.dirname(os.path.abspath(__file__))
    smi = phase_device()
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_sparse_kernels(results)
    phase_small()
    phase_small_sparse()
    launches: dict = {}
    phase_main(launches)
    phase_sparse(launches)
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
