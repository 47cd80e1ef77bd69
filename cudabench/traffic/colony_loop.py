"""Closed loop of one research colony: ``colony_step`` back to back.

Set-up draws the instance from the seed (uniform coordinates in the
configuration's box, its rounding rule), builds the program's problem and
seeded state through ``repro_torch.core.aco`` (``make_problem``,
``init_colony``) and drives that same state through its first iterations
with the window's own call, ``colony_step``; those iterations build and
load the kernels and warm every shape the window uses.  The window then
iterates the same state with nothing read back: the host waits on a CUDA
event only to stay ``inflight`` iterations ahead of the card.

With ``restart_every`` the colony starts afresh from the next seed every
that many iterations, as a sweep over seeds does, so the work per
iteration stays the same through the window (2-opt's rounds thin out as
a colony converges).

``correct`` compares, with the plain reference (``reference/aco.py``):
the start (tau0 and the key), the set-up's iterations followed by the
reference from the seed on its own state (tours through tau, best
tracking, keys), and the window's last iteration followed from the
program's state before it.  Every comparison is exact: the program's
construction and update are bitwise reproducible.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from cudabench import peaks
from cudabench import trace as tr
from cudabench.reference import aco as ref


def coordinates(seed: int, n: int, box: float) -> np.ndarray:
    """n uniform cities in a box, from the seed."""
    return np.random.default_rng(seed).uniform(0.0, box, size=(n, 2))


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.to(b.device), b
    return int((a.reshape(-1).to(b.dtype) != b.reshape(-1)).sum())


class Session:
    def __init__(self, cell, seed: int, device, seconds: float,
                 trace: bool = False):
        from repro_torch.core import aco, tsp
        conf, mix = cell.config, cell.traffic
        self.aco = aco
        self.cfg = aco.ACOConfig(**conf["aco"], **mix.get("aco", {}))
        self.device = torch.device(device)
        self.trace = trace
        self.n = int(mix["n"])
        inst = conf["instance"]
        self.rule = inst["edge_weight_type"]
        self.coords = coordinates(seed, self.n, float(inst["box"]))
        self.seed = int(seed)
        self.inflight = int(mix.get("inflight", 2))
        cfg = self.cfg
        if cfg.local_search not in ("none", "2opt") or (
                cfg.local_search == "2opt"
                and (cfg.ls_improvement, cfg.ls_every, cfg.ls_tours)
                != ("best", 1, "all")):
            raise ValueError("the reference polishes every tour every "
                             "iteration by best-improvement 2-opt, or not")
        self.ls_rounds = cfg.ls_rounds if cfg.local_search == "2opt" else 0
        self.restart_every = int(mix.get("restart_every", 0))
        self.restarts = 0
        instance = tsp.TSPInstance(f"u{self.n}", coords=self.coords,
                                   edge_weight_type=self.rule)
        self.instance = instance
        self.m = self.cfg.num_ants(self.n)
        self.problem = aco.make_problem(instance, self.cfg.nn_k, self.device)
        self.start = aco.init_colony(instance, self.cfg, seed=self.seed,
                                     device=self.device)
        state, self.setup_steps = self.start, []
        for _ in range(int(mix.get("setup_iterations", 3))):
            state, it_best = aco.colony_step(self.problem, state, self.cfg)
            self.setup_steps.append((state, it_best))
        self.state, self.prev = state, None
        self.iterations = 0
        self.age = len(self.setup_steps)   # iterations since the last start
        self._sync()

    def _restart(self):
        """A fresh seeded colony on the same instance, as a sweep over
        seeds starts one."""
        self.restarts += 1
        self.age = 0
        return self.aco.init_colony(self.instance, self.cfg,
                                    seed=self.seed + self.restarts,
                                    device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> float:
        """Iterate for ``seconds`` of host time; returns the window's wall
        seconds, ended by a synchronize."""
        cuda = self.device.type == "cuda"
        pending: deque = deque()
        step, problem, cfg = self.aco.colony_step, self.problem, self.cfg
        state, prev, it_best = self.state, None, None
        self._sync()
        with tr.annotate(tr.WINDOW, self.trace):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if self.restart_every and self.age >= self.restart_every:
                    with tr.annotate("cudabench.restart", self.trace):
                        state = self._restart()
                prev = state
                with tr.annotate("cudabench.colony_step", self.trace):
                    state, it_best = step(problem, state, cfg)
                self.iterations += 1
                self.age += 1
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    pending.append(ev)
                    if len(pending) > self.inflight:
                        with tr.annotate("cudabench.wait", self.trace):
                            pending.popleft().synchronize()
            self._sync()
            wall = time.perf_counter() - t0
        self.state, self.prev, self.it_best = state, prev, it_best
        return wall

    def finish(self) -> None:
        """Nothing is left in flight after the window's synchronize."""

    def results(self, wall: float) -> dict:
        return {"attempted": self.iterations, "failed": 0,
                "metrics": {"iter_ms": wall * 1e3 / self.iterations}}

    def walk_bound_s(self) -> float:
        return peaks.bound_s(*peaks.walk_counts(self.n, self.m))

    def free(self) -> None:
        """Drop the program's problem (its state's tensors stay for the
        comparison)."""
        self.problem = None

    # ---------------------------------------------------------- the check
    def _ref_state(self, st) -> ref.State:
        return ref.State(st.tau[None].float(), st.best_tour[None].long(),
                         st.best_len[None].float(), st.key[None].long())

    def _best_off(self, got, it_best, want: ref.State, want_it) -> int:
        return (_mismatches(got.best_tour, want.best_tour)
                + _mismatches(got.best_len, want.best_len)
                + _mismatches(got.key, want.key)
                + _mismatches(it_best, want_it))

    def check(self) -> dict:
        """The numbers compared, each (value, limit)."""
        d = ref.distances(self.coords, self.rule)
        col = ref.make_colony([d], self.n, self.m, self.device,
                              self.cfg.nn_k if self.ls_rounds else 0)
        own = ref.initial_state([d], self.n, [self.seed], [self.m],
                                self.device)
        out = {"start_off": _mismatches(self.start.tau, own.tau)
               + _mismatches(self.start.key, own.key)}
        tau_off = best_off = 0
        for got, it_best in self.setup_steps:
            own, want_it, _ = ref.iterate(col, own, self.cfg.q, self.cfg.rho,
                                          ls_rounds=self.ls_rounds)
            tau_off += _mismatches(got.tau, own.tau)
            best_off += self._best_off(got, it_best, own, want_it)
        out["setup_tau_off"], out["setup_best_off"] = tau_off, best_off
        if self.prev is not None:
            # the window's last iteration, followed from the program's
            # state before it
            want, want_it, _ = ref.iterate(col, self._ref_state(self.prev),
                                           self.cfg.q, self.cfg.rho,
                                           ls_rounds=self.ls_rounds)
            out["window_tau_off"] = _mismatches(self.state.tau, want.tau)
            out["window_best_off"] = self._best_off(self.state, self.it_best,
                                                    want, want_it)
        return {k: (v, 0) for k, v in out.items()}
