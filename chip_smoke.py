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
   modes; times each (CUDA events) beside its plain version and its bound;
4. small   -- the one-rounding multiply-add (``torch.addcmul``) and the
   per-step draw on the card against the CPU, bitwise; a small colony on
   the card's kernel route against the same colony on the CPU (plain
   versions), and no worse than the nearest-neighbour tour;
5. main    -- ``aco.run`` at n = m = 1002: AS, MMAS and ACS on the fused
   kernel route and AS on ``construction="pallas"``; one AS iteration at
   n = m = 2392 (the paper's pr2392).  Launch counts are zeroed before
   each run and checked after it.  MMAS runs until its best tour is no
   worse than the nearest-neighbour tour; the shorter runs are held to
   1.2 x that tour;
6. profile -- device busy time and idle share of one AS iteration at
   n = 1002, and the kernels that take most of it;
7. one JSON line listing every kernel, then the card's ``nvidia-smi``
   line, then the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
}
MODES = ("iroulette", "gumbel", "greedy")
# MMAS at n = 1002 runs in chunks of this many iterations until its best
# tour is no worse than the nearest-neighbour tour, and fails at the cap.
MMAS_CHUNK, MMAS_CAP = 5, 40


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
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import (choice_info as ci, fused_select as fs,
                                     pheromone_update as pu, tour_select as ts)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {k: 0.0 for k in KERNELS}

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
        log(f"[kernels] n={n} n_actual={n_act}: choice_info, tour_select, "
            f"fused_select bitwise in {', '.join(MODES)}; pheromone_update "
            f"bitwise (1 ant), rtol 1e-5/atol 1e-7 ({m} ants)")

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
        log(f"[kernels] {name} n=m=1002: device {ms * 1e3:.2f} us, per call "
            f"{wall * 1e3:.1f} us | plain device {plain_ms * 1e3:.1f} us, per "
            f"call {plain_wall * 1e3:.1f} us"
            + (f" | library device {lib_ms * 1e3:.1f} us, per call "
               f"{lib_wall * 1e3:.1f} us" if lib_fn else "")
            + f" | bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({nbytes / 1e6:.1f} MB)")

    # The per-step draw (plain PyTorch, the reference's jax.random outside
    # any kernel) that feeds fused_select / tour_select on the main path.
    from repro_torch.core import sampling, strategies
    key = sampling.prng_key(0, dev)
    draw = lambda: strategies._draw_step_uniform(key, (m, n), "packed")  # noqa: E731
    d_ms, d_wall = both(draw, 5)
    log(f"[kernels] per-step draw U(1e-6, 1) at (1002, 1002), plain: device "
        f"{d_ms * 1e3:.1f} us, per call {d_wall * 1e3:.1f} us")


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
    route == CPU plain route on a small colony (MMAS: tours, best_len and
    tau bitwise; AS: tours and best_len after one iteration)."""
    import torch
    from repro_torch.core import aco, sampling, strategies, tsp
    gen = torch.Generator().manual_seed(1)
    a, c = torch.rand((2, 1002, 1002), generator=gen)
    for b in (torch.tensor(0.9), torch.rand((1002, 1002), generator=gen)):
        want = torch.addcmul(c, b, a)
        got = torch.addcmul(c.cuda(), b.cuda(), a.cuda()).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"addcmul on the card != CPU in "
                                 f"{int((got != want).sum())} cells")
    for mode in ("packed", "counter"):
        want = strategies._draw_step_uniform(sampling.prng_key(7, "cpu"),
                                             (1002, 1002), mode)
        got = strategies._draw_step_uniform(sampling.prng_key(7, "cuda"),
                                            (1002, 1002), mode).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"{mode} draw on the card != CPU in "
                                 f"{int((got != want).sum())} cells")
    log("[small] addcmul (one rounding) and the per-step draw at (1002, "
        "1002): card == CPU bitwise")
    inst = tsp.random_instance(100, seed=5)
    for variant, iters, tau_exact in (("mmas", 10, True), ("as", 1, False)):
        cfg = aco.ACOConfig(variant=variant, iterations=iters, seed=3,
                            use_pallas=True)
        gpu = aco.run(inst, cfg, device="cuda")
        cpu = aco.run(inst, cfg, device="cpu")
        same = (torch.equal(gpu.best_tour.cpu(), cpu.best_tour)
                and torch.equal(gpu.best_len.cpu(), cpu.best_len))
        if not same:
            raise AssertionError(f"small {variant}: card route != CPU route")
        if tau_exact:
            if not torch.equal(gpu.tau.cpu(), cpu.tau):
                raise AssertionError(f"small {variant}: tau differs")
        else:
            torch.testing.assert_close(gpu.tau.cpu(), cpu.tau, rtol=1e-5,
                                       atol=1e-7)
        best, c_nn = _check_run(f"small {variant}", gpu, inst, 100,
                                1.0 if variant == "mmas" else 1.5)
        log(f"[small] rand100 {variant} x{iters}: card == CPU (tours, "
            f"best_len, tau {'bitwise' if tau_exact else 'rtol 1e-5'}); "
            f"best {best:.1f} vs nearest-neighbour tour {c_nn:.1f}")


def phase_main(launches: dict) -> None:
    import torch
    from repro_torch.core import aco, tsp
    from repro_torch.kernels import ops
    # (label, n, cfg kwargs, expected launches per iteration, the most
    # best_len may be as a multiple of the nearest-neighbour tour, the
    # iteration cap when the run goes on until it meets that limit).  MMAS
    # runs until it reaches that tour; the others take a few iterations and
    # are held to 1.2 x it.
    runs = [
        ("as", 1002, dict(variant="as", iterations=3),
         {"fused_select": 1001, "pheromone_update": 1}, 1.2, None),
        ("mmas", 1002, dict(variant="mmas", iterations=2 * MMAS_CHUNK),
         {"fused_select": 1001, "pheromone_update": 1}, 1.0, MMAS_CAP),
        ("acs", 1002, dict(variant="acs", iterations=3),
         {"fused_select": 1001, "pheromone_update": 1}, 1.2, None),
        ("as-pallas", 1002, dict(variant="as", iterations=2,
                                 construction="pallas"),
         {"choice_info": 1, "tour_select": 1001, "pheromone_update": 1}, 1.2,
         None),
        ("as", 2392, dict(variant="as", iterations=1),
         {"fused_select": 2391, "pheromone_update": 1}, 1.2, None),
    ]
    instances = {}
    for label, n, kw, per_iter, slack, cap in runs:
        inst = instances.setdefault(n, tsp.random_instance(n))
        _, c_nn = tsp.nearest_neighbour_tour(inst.distances())
        cfg = aco.ACOConfig(use_pallas=True, seed=0, **kw)
        bests = []      # best_len after each iteration
        record = dict(checkpoint_cb=lambda s: bests.append(float(s.best_len)),
                      checkpoint_every=1)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = aco.run(inst, cfg, device="cuda", **record)
        # resume from the state in chunks until the limit or the cap
        while cap and bests[-1] > slack * c_nn and len(bests) < cap:
            cfg = dataclasses.replace(cfg, iterations=len(bests) + MMAS_CHUNK)
            state = aco.run(inst, cfg, state=state, **record)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {k: v * cfg.iterations for k, v in per_iter.items()}
        for k in counts:
            if counts[k] != want.get(k, 0):
                raise AssertionError(f"main {label} n={n}: {k} launched "
                                     f"{counts[k]} times, expected "
                                     f"{want.get(k, 0)}")
            launches[k] = launches.get(k, 0) + counts[k]
        best, c_nn = _check_run(f"main {label} n={n}", state, inst, n, slack)
        log(f"[main] {label} n=m={n} x{cfg.iterations}: "
            f"{cfg.iterations / secs:.3f} it/s ({secs:.2f} s incl. set-up), "
            f"best {best:.1f} ({best / c_nn:.3f} x NN tour, limit {slack}), "
            f"launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v)
            + f", peak mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        log(f"[main]   best / NN tour after each iteration: "
            + " ".join(f"{b / c_nn:.3f}" for b in bests))


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


def main() -> int:
    import torch   # noqa: F401  (fails here when torch is absent)
    root = os.path.dirname(os.path.abspath(__file__))
    smi = phase_device()
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_small()
    launches: dict = {}
    phase_main(launches)
    phase_profile()
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        if launches.get(name, 0) == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
