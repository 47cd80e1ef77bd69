"""Sequential Ant System in pure NumPy (a copy of ``repro.core.sequential``).

Mirrors the structure of Stützle's ANSI-C ACOTSP code (the paper's CPU
baseline): per-ant sequential roulette-wheel construction with precomputed
choice_info, then evaporation + per-edge deposit. Used as (a) the wall-clock
baseline for the Fig. 4/5 speed-up reproductions and (b) the solution-quality
oracle for claim C6.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class SequentialAS:
    def __init__(self, dist: np.ndarray, alpha: float = 1.0, beta: float = 2.0,
                 rho: float = 0.5, m: Optional[int] = None, seed: int = 0,
                 nn_k: int = 0):
        self.dist = np.asarray(dist, np.float64)
        self.n = self.dist.shape[0]
        self.m = m if m is not None else self.n
        self.alpha, self.beta, self.rho = alpha, beta, rho
        self.rng = np.random.RandomState(seed)
        eps = 1e-10
        self.eta = 1.0 / np.maximum(self.dist, eps)
        # tau0 = m / C_nn
        c_nn = self._nn_tour_length()
        self.tau = np.full((self.n, self.n), self.m / c_nn)
        self.best_tour = None
        self.best_len = np.inf
        self.nn_k = nn_k
        if nn_k:
            d = self.dist + np.eye(self.n) * 1e18
            self.nn = np.argsort(d, axis=1)[:, :nn_k]

    def _nn_tour_length(self) -> float:
        visited = np.zeros(self.n, bool)
        cur, total = 0, 0.0
        visited[0] = True
        for _ in range(self.n - 1):
            d = np.where(visited, np.inf, self.dist[cur])
            nxt = int(np.argmin(d))
            total += self.dist[cur, nxt]
            visited[nxt] = True
            cur = nxt
        return total + self.dist[cur, 0]

    def construct(self) -> tuple[np.ndarray, np.ndarray]:
        choice = (self.tau ** self.alpha) * (self.eta ** self.beta)
        tours = np.empty((self.m, self.n), np.int32)
        lengths = np.empty(self.m)
        for k in range(self.m):
            visited = np.zeros(self.n, bool)
            cur = self.rng.randint(self.n)
            tours[k, 0] = cur
            visited[cur] = True
            for s in range(1, self.n):
                if self.nn_k:
                    cand = self.nn[cur]
                    w = choice[cur, cand] * (~visited[cand])
                    tot = w.sum()
                    if tot > 0:
                        r = self.rng.uniform(0, tot)
                        nxt = int(cand[np.searchsorted(np.cumsum(w), r)])
                    else:
                        full = choice[cur] * (~visited)
                        nxt = int(np.argmax(full))
                else:
                    w = choice[cur] * (~visited)
                    r = self.rng.uniform(0, w.sum())
                    nxt = int(np.searchsorted(np.cumsum(w), r))
                    nxt = min(nxt, self.n - 1)
                tours[k, s] = nxt
                visited[nxt] = True
                cur = nxt
            lengths[k] = self.dist[tours[k], np.roll(tours[k], -1)].sum()
        return tours, lengths

    def update_pheromone(self, tours: np.ndarray, lengths: np.ndarray) -> None:
        self.tau *= (1.0 - self.rho)
        for k in range(tours.shape[0]):
            w = 1.0 / lengths[k]
            t = tours[k]
            nxt = np.roll(t, -1)
            self.tau[t, nxt] += w
            self.tau[nxt, t] += w

    def iterate(self) -> float:
        tours, lengths = self.construct()
        i = int(np.argmin(lengths))
        if lengths[i] < self.best_len:
            self.best_len = float(lengths[i])
            self.best_tour = tours[i].copy()
        self.update_pheromone(tours, lengths)
        return float(lengths[i])

    def run(self, iterations: int) -> float:
        for _ in range(iterations):
            self.iterate()
        return self.best_len
