"""Plain reference of the Ant System colony that the benchmark checks.

Written from the algorithm's definition, in plain PyTorch and NumPy; it
imports nothing of the program under test.  It works out every quantity
again from the inputs the harness hands to both sides (coordinates and
seeds): distances with their rounding rule, the heuristic, the greedy
nearest-neighbour tour and tau0, the random stream, the tours, their
lengths, the update and the best tour.

The random stream is the counter-based Threefry-2x32 hash (Salmon et al.,
SC'11; 20 rounds, the rotations of the Random123 reference), used as
counter-mode PRNGs use it: a key is two 32-bit words; ``split(key, i)``
and ``fold_in(key, i)`` hash the counter (0, i); a draw over an (m, n)
grid hashes each flat index and takes ``y0 ^ y1``; the top 23 bits become
a float in [0, 1) that is scaled into [1e-6, 1) with one rounding.  The
construction is the paper's I-Roulette: each ant at each step takes the
unvisited city with the largest ``tau * eta^2 * U``, the lowest index
among equal maxima.  The update evaporates tau by ``1 - rho`` and then
adds each ant's ``q / L`` to both directed cells of each tour edge, in
the order of one edge stream (every ant's forward edges, ant by ant, then
the reversed ones), one float32 addition at a time.

Two things make it fast enough to follow a colony at n = 2392 on the
card with plain operations:

- A draw is hashed only for each ant's K largest weights: U <= 1, so a
  city whose weight is below the best product of those K cannot win;
  the few ants a step for which that is not settled hash their whole row.
  A step then has fixed shapes and reads nothing back, and on the card it
  is recorded once as a CUDA graph and replayed.
- The sequential deposits run as one vector addition per rank within a
  cell (the k-th deposit of every cell at once), which keeps each cell's
  order.

Every function takes a leading stack axis S of independent colonies.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
UNIFORM_LO = np.float32(1e-6)
UNIFORM_SPAN = np.float32(1.0) - np.float32(1e-6)
TOPK = 32
SPARE = 64


# ------------------------------------------------------------ the stream

def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds over int64 tensors holding uint32."""
    k2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + keys[(group + 1) % 3]) & MASK
        x1 = (x1 + keys[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def seed_key(seed: int, device) -> torch.Tensor:
    """The (2,) key of a 64-bit seed: high word, low word."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def derive(keys: torch.Tensor, counter) -> torch.Tensor:
    """(S, 2) keys -> (S, 2) keys hashed with the counter (0, counter);
    ``counter`` is an int or an (S,) tensor."""
    lo = torch.as_tensor(counter, dtype=torch.int64,
                         device=keys.device).expand(keys.shape[:1]) & MASK
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of each (S, ...) flat grid index under its row's key."""
    lead = (keys.shape[0],) + (1,) * (flat.dim() - 1)
    y0, y1 = threefry2x32(keys[:, 0].reshape(lead), keys[:, 1].reshape(lead),
                          flat >> 32, flat & MASK)
    return y0 ^ y1


def uniform(b: torch.Tensor) -> torch.Tensor:
    """Bits -> U[1e-6, 1) float32: 23 bits into [0, 1), then lo + f * span
    rounded once (exact in float64, so one rounding to float32)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = (f.double() * float(UNIFORM_SPAN) + float(UNIFORM_LO)).float()
    return torch.clamp_min(u, float(UNIFORM_LO))


def randint(keys: torch.Tensor, count: int, spans: torch.Tensor
            ) -> torch.Tensor:
    """(S, count) ints in [0, spans[s]) from two 32-bit draws per value,
    combined modulo the span in wrapping 32-bit arithmetic."""
    k_hi, k_lo = derive(keys, 0), derive(keys, 1)
    flat = torch.arange(count, dtype=torch.int64,
                        device=keys.device).expand(keys.shape[0], count)
    hi, lo = bits(k_hi, flat), bits(k_lo, flat)
    span = spans.to(torch.int64).clamp_min(1)[:, None]
    mult = ((1 << 16) % span) ** 2 & MASK
    mult = mult % span
    off = (((hi % span) * mult) & MASK) + lo % span
    return (off & MASK) % span


# ------------------------------------------------------------ instances

def distances(coords: np.ndarray, rule: str) -> np.ndarray:
    """(n, n) float32 distances: Euclidean in float64, rounded to the
    nearest integer under TSPLIB's EUC_2D, as they are under RAW."""
    xy = np.asarray(coords, np.float64)
    d = np.sqrt(((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1))
    if rule == "EUC_2D":
        d = np.rint(d)
    elif rule != "RAW":
        raise ValueError(f"unknown distance rule {rule!r}")
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def nn_tour_length(d: np.ndarray) -> float:
    """Length of the greedy nearest-neighbour tour from city 0 (lowest
    index among equal distances), summed in float32 as NumPy sums."""
    n = d.shape[0]
    seen = np.zeros(n, dtype=bool)
    tour = np.empty(n, dtype=np.int64)
    cur = 0
    tour[0] = cur
    seen[cur] = True
    for i in range(1, n):
        cur = int(np.argmin(np.where(seen, np.inf, d[cur])))
        tour[i] = cur
        seen[cur] = True
    return float(d[tour, np.roll(tour, -1)].sum())


class Colony(NamedTuple):
    """A stack of S colonies over instances padded to N cities."""
    dist: torch.Tensor       # (S, N, N) float32, inf off the real block
    eta2: torch.Tensor       # (S, N, N) float32, eta * eta
    n_act: torch.Tensor      # (S,) int64 real cities
    ants: int                # ants per colony
    nn: Optional[torch.Tensor] = None   # (S, N, k) 2-opt candidates


class State(NamedTuple):
    tau: torch.Tensor        # (S, N, N) float32
    best_tour: torch.Tensor  # (S, N) int64
    best_len: torch.Tensor   # (S,) float32
    key: torch.Tensor        # (S, 2) int64


def nn_lists(d: np.ndarray, k: int) -> np.ndarray:
    """(n, k) nearest cities of each city, itself excluded, ties by
    index."""
    d = d.copy()
    np.fill_diagonal(d, np.finfo(np.float32).max)
    return np.argsort(d, axis=1, kind="stable")[:, :min(k, d.shape[0] - 1)]


def make_colony(dists: Sequence[np.ndarray], pad: int, ants: int,
                device, nn_k: int = 0) -> Colony:
    """Stack real (n, n) distance matrices padded to ``pad`` cities:
    phantom cities lie at infinite distance (diagonal 0), so their eta is
    0.  ``nn_k`` > 0 adds the 2-opt candidate lists (unpadded stacks)."""
    s = len(dists)
    d = np.full((s, pad, pad), np.inf, dtype=np.float32)
    for i, di in enumerate(dists):
        k = di.shape[0]
        d[i, :k, :k] = di
        np.fill_diagonal(d[i], 0.0)
    dist = torch.from_numpy(d).to(device)
    eta = torch.ones_like(dist) / torch.maximum(
        dist, torch.tensor(1e-10, dtype=torch.float32, device=device))
    n_act = torch.tensor([di.shape[0] for di in dists], dtype=torch.int64,
                         device=device)
    nn = None
    if nn_k:
        if any(di.shape[0] != pad for di in dists):
            raise ValueError("2-opt candidates are for unpadded stacks")
        nn = torch.from_numpy(np.stack([nn_lists(di, nn_k) for di in dists])
                              ).to(device)
    return Colony(dist, eta * eta, n_act, ants, nn)


def initial_state(dists: Sequence[np.ndarray], pad: int, seeds, ants_tau0,
                  device) -> State:
    """tau0 = m / C_nn of each real instance (``ants_tau0[s]`` ants), the
    identity tour at infinite length, and each seed's key."""
    tau0 = [np.float32(a / nn_tour_length(d))
            for a, d in zip(ants_tau0, dists)]
    s = len(dists)
    tau = torch.empty((s, pad, pad), dtype=torch.float32, device=device)
    for i, t in enumerate(tau0):
        tau[i].fill_(float(t))
    return State(
        tau=tau,
        best_tour=torch.arange(pad, device=device).expand(s, pad).clone(),
        best_len=torch.full((s,), float("inf"), dtype=torch.float32,
                            device=device),
        key=torch.stack([seed_key(x, device) for x in seeds]))


# ---------------------------------------------------------- construction

def _times(w: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    """``w * u`` rounded in ``dtype``, held in float32."""
    return (w.to(dtype) * u.to(dtype)).float()


class _Walk:
    """The steps of one construction over buffers that persist between
    steps, so that a step has fixed shapes and reads nothing back: on the
    card one step is recorded as a CUDA graph and replayed.

    At each step every ant hashes its K largest selectable weights and
    takes the lowest index of the largest ``w * U`` (rounded in
    ``dtype``), U hashed at ant a's grid index ``a * N + city`` under its
    instance's step key.  U <= 1, so a city outside the K (weighing at
    most the K-th weight) can reach the best product only where the K-th
    weight is not below it: up to ``spare`` such ants a step hash their
    whole row instead; ``overflow`` records a step that had more."""

    def __init__(self, col: Colony, w_all: torch.Tensor, start: torch.Tensor,
                 step_keys: torch.Tensor, k: int, dtype, spare: int):
        s, m = start.shape
        n = w_all.shape[-1]
        dev = w_all.device
        self.col, self.w_all, self.step_keys, self.dtype = \
            col, w_all, step_keys, dtype
        self.k, self.spare = min(k, n), min(spare, s * m)
        self.sidx = torch.arange(s, device=dev)[:, None]
        self.ants = torch.arange(m, device=dev)[None, :].expand(s, m)
        self.cols = torch.arange(n, device=dev)
        self.real = self.cols[None, :] < col.n_act[:, None]          # (S, N)
        self.visited = torch.zeros((s, m, n), dtype=torch.bool, device=dev)
        self.visited[self.sidx, self.ants, start] = True
        self.true = torch.ones((), dtype=torch.bool, device=dev)
        self.cur = start.clone()
        self.steps = torch.empty((s, max(n - 1, 0), m), dtype=torch.int64,
                                 device=dev)
        self.t = torch.ones(1, dtype=torch.int64, device=dev)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)

    def step(self) -> None:
        s, m = self.cur.shape
        n = self.w_all.shape[-1]
        t = self.t
        rows = self.w_all[self.sidx, self.cur]                      # (S,m,N)
        rows = torch.where(~self.visited & self.real[:, None, :], rows,
                           torch.zeros_like(rows))
        keys = self.step_keys.index_select(1, t - 1)[:, 0]          # (S, 2)
        vals, idx = torch.topk(rows, self.k, dim=-1)
        u = uniform(bits(keys, self.ants[..., None] * n + idx))
        prod = _times(vals, u, self.dtype)
        best = prod.max(dim=-1, keepdim=True).values
        pick = torch.where(prod == best, idx, torch.full_like(idx, n)
                           ).min(dim=-1).values
        live = t < self.col.n_act[:, None]                          # (S, 1)
        if self.k < n:
            # U <= 1: a city outside the K weighs at most the K-th weight
            open_ = live & (vals[..., -1] >= best[..., 0])
            flag, which = torch.topk(open_.reshape(-1).to(torch.float32),
                                     self.spare)
            row = rows.reshape(s * m, n).index_select(0, which)     # (R, N)
            flat = (which % m)[:, None] * n + self.cols[None, :]
            full = _times(row, uniform(bits(keys.index_select(0, which // m),
                                            flat)), self.dtype)
            pick = pick.reshape(-1)
            pick = pick.index_copy(0, which, torch.where(
                flag > 0, torch.argmax(full, dim=-1),
                pick.index_select(0, which))).reshape(s, m)
            self.overflow |= open_.sum() > self.spare
        nxt = torch.where(live, pick, t)
        self.visited.index_put_((self.sidx, self.ants, nxt), self.true)
        self.steps.index_copy_(1, t - 1, nxt[:, None, :])
        self.cur.copy_(nxt)
        self.t += 1

    def run(self) -> torch.Tensor:
        """Steps 1..N-1 -> (S, N-1, m) cities."""
        n = self.w_all.shape[-1]
        top = int(self.col.n_act.max())
        live_steps = max(top - 1, 0)
        if self.w_all.device.type == "cuda" and live_steps > 1:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step()
            for _ in range(live_steps - 1):
                graph.replay()
        else:
            for _ in range(live_steps):
                self.step()
        # past every instance's real cities: the phantom tail in order
        self.steps[:, live_steps:] = torch.arange(
            live_steps + 1, n, device=self.steps.device)[None, :, None]
        return self.steps


def construct(col: Colony, tau: torch.Tensor, key_tour: torch.Tensor,
              weight_dtype: torch.dtype = torch.float32, k: int = TOPK,
              spare: int = SPARE) -> torch.Tensor:
    """(S, m, N) tours: starts from ``randint``, then N - 1 steps, step t
    drawing from ``fold_in(kc, t)``; steps at or past an instance's real
    count emit city t (the phantom tail in index order).
    ``weight_dtype`` below float32 rounds the weights and their products
    with the draws to it (the benchmark's lower-precision control).  A
    construction in which some step left more than ``spare`` ants to be
    hashed whole runs again with every ant's row at hand."""
    n = tau.shape[-1]
    dev = tau.device
    kp, kc = derive(key_tour, 0), derive(key_tour, 1)
    start = randint(kp, col.ants, col.n_act)                    # (S, m)
    if weight_dtype == torch.float32:
        w_all = tau * col.eta2
    else:
        w_all = (tau.to(weight_dtype) * col.eta2.to(weight_dtype)).float()
    t = torch.arange(1, max(n, 2), dtype=torch.int64, device=dev)[None, :]
    y0, y1 = threefry2x32(kc[:, :1], kc[:, 1:], torch.zeros_like(t), t)
    step_keys = torch.stack([y0, y1], dim=-1)                   # (S, n-1, 2)
    walk = _Walk(col, w_all, start, step_keys, k, weight_dtype, spare)
    steps = walk.run()
    if bool(walk.overflow):
        walk = _Walk(col, w_all, start, step_keys, k, weight_dtype,
                     start.numel())
        steps = walk.run()
    return torch.cat([start[:, None], steps], dim=1).transpose(1, 2)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving, zero-padded at odd widths."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _next_city(tours: torch.Tensor, n_act: torch.Tensor) -> torch.Tensor:
    """Each position's successor; the closing edge leaves the last real
    position for position 0."""
    nxt = torch.roll(tours, -1, dims=-1)
    pos = torch.arange(tours.shape[-1], device=tours.device)
    last = pos == (n_act - 1).reshape(-1, *([1] * (tours.dim() - 1)))
    return torch.where(last, tours[..., :1], nxt)


def tour_lengths(dist: torch.Tensor, tours: torch.Tensor,
                 n_act: torch.Tensor) -> torch.Tensor:
    """(S, ..., N) tours -> (S, ...) closed lengths over the real
    positions, summed pairwise in float32."""
    s = dist.shape[0]
    lead = (s,) + (1,) * (tours.dim() - 1)
    nxt = _next_city(tours, n_act)
    d = dist[torch.arange(s, device=dist.device).reshape(lead), tours, nxt]
    pos = torch.arange(tours.shape[-1], device=dist.device)
    real = pos < n_act.reshape(lead)
    return _pairwise_sum(torch.where(real, d, torch.zeros_like(d)))


def update(tau: torch.Tensor, tours: torch.Tensor, weights: torch.Tensor,
           n_act: torch.Tensor, rho: float) -> torch.Tensor:
    """Evaporate, then add each ant's weight to both directed cells of its
    real tour edges in edge-stream order, one float32 addition at a time."""
    s, m, n = tours.shape
    dev = tau.device
    out = (torch.tensor(np.float32(1.0 - rho), device=dev) * tau).reshape(-1)
    nxt = _next_city(tours, n_act)
    pos = torch.arange(n, device=dev)
    real = (pos[None, None, :] < n_act[:, None, None]).expand(s, m, n)
    base = (torch.arange(s, device=dev) * n * n)[:, None, None]
    fwd = (base + tours * n + nxt)[real]
    bwd = (base + nxt * n + tours)[real]
    w = weights[:, :, None].expand(s, m, n)[real]
    cells = torch.cat([fwd, bwd])
    w = torch.cat([w, w])
    order = torch.sort(cells, stable=True).indices
    cells, w = cells[order], w[order]
    first = torch.ones_like(cells, dtype=torch.bool)
    first[1:] = cells[1:] != cells[:-1]
    start = torch.cummax(torch.where(
        first, torch.arange(cells.numel(), device=dev),
        torch.zeros_like(cells)), dim=0).values
    rank = torch.arange(cells.numel(), device=dev) - start
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        c = cells[sel]
        out[c] = out[c] + w[sel]
    return out.view(s, n, n)


def two_opt(dist: torch.Tensor, nn: torch.Tensor, tours: torch.Tensor,
            rounds: int, min_delta: float) -> torch.Tensor:
    """Best-improvement 2-opt over the candidate lists, every tour of the
    (S, m, n) stack at once: each round, each ant takes its move of least
    delta ``d(a,c) + d(a',c') - d(a,a') - d(c,c')`` (summed in that order
    in float32; moves that share a tour edge excluded; the first among
    equal deltas in (position, candidate) order) and reverses the tour
    between the two edges where the delta is below ``-min_delta``; at most
    ``rounds`` rounds, ending after one that changes no tour."""
    s, m, n = tours.shape
    k = nn.shape[-1]
    dev = tours.device
    b = torch.arange(s, device=dev).reshape(s, 1, 1, 1)
    thr = torch.tensor(-np.float32(min_delta), device=dev)
    idx_n = torch.arange(n, device=dev)
    for _ in range(rounds):
        pos = torch.empty_like(tours).scatter_(
            -1, tours, idx_n.expand(s, m, n).contiguous())
        succ = torch.roll(tours, -1, dims=-1)
        a, a2 = tours[..., None], succ[..., None]                # (S,m,n,1)
        c = nn[b[..., 0], tours]                                 # (S,m,n,k)
        j = torch.gather(pos, -1, c.reshape(s, m, -1)).reshape(c.shape)
        c2 = torch.gather(succ, -1, j.reshape(s, m, -1)).reshape(c.shape)
        delta = ((col_dist(dist, b, a, c) + col_dist(dist, b, a2, c2))
                 - col_dist(dist, b, a, a2)) - col_dist(dist, b, c, c2)
        ok = (c != a2) & (c2 != a)
        v = torch.where(ok, delta, torch.tensor(1e30, device=dev))
        v = v.reshape(s, m, -1)
        best = torch.argmin(v, dim=-1)                           # (S, m)
        val = v.gather(-1, best[..., None])[..., 0]
        p = best // k
        q = j.reshape(s, m, -1).gather(-1, best[..., None])[..., 0]
        lo, hi = torch.minimum(p, q)[..., None], torch.maximum(p, q)[..., None]
        src = torch.where((idx_n > lo) & (idx_n <= hi), lo + 1 + hi - idx_n,
                          idx_n)
        src = torch.where((val < thr)[..., None], src, idx_n)
        new = torch.gather(tours, -1, src)
        if not bool((new != tours).any()):
            break
        tours = new
    return tours


def col_dist(dist: torch.Tensor, b: torch.Tensor, i: torch.Tensor,
             j: torch.Tensor) -> torch.Tensor:
    """``dist[s, i, j]`` of each index pair's own instance."""
    i, j = torch.broadcast_tensors(i, j)
    return dist[b.expand(i.shape[:1] + (1,) * (i.dim() - 1)), i, j]


def iterate(col: Colony, st: State, q: float = 1.0, rho: float = 0.5,
            weight_dtype: torch.dtype = torch.float32, k: int = TOPK,
            ls_rounds: int = 0, ls_min_delta: float = 1e-3,
            spare: int = SPARE) -> tuple[State, torch.Tensor, torch.Tensor]:
    """One Ant System iteration of every colony of the stack: (state,
    iteration-best lengths (S,), tours (S, m, N)); with ``ls_rounds`` > 0
    every tour is polished by ``two_opt`` before it is measured."""
    key_next, key_tour = derive(st.key, 0), derive(st.key, 1)
    tours = construct(col, st.tau, key_tour, weight_dtype, k, spare)
    if ls_rounds > 0:
        tours = two_opt(col.dist, col.nn, tours, ls_rounds, ls_min_delta)
    lengths = tour_lengths(col.dist, tours, col.n_act)           # (S, m)
    it_idx = torch.argmin(lengths, dim=-1)
    it_len = lengths.gather(1, it_idx[:, None])[:, 0]
    it_tour = tours[torch.arange(tours.shape[0], device=tours.device),
                    it_idx]
    better = it_len < st.best_len
    tau = update(st.tau, tours, torch.tensor(np.float32(q),
                                             device=tours.device) / lengths,
                 col.n_act, rho)
    return State(tau, torch.where(better[:, None], it_tour, st.best_tour),
                 torch.where(better, it_len, st.best_len), key_next), \
        it_len, tours


def run(col: Colony, st: State, iterations: int, q: float = 1.0,
        rho: float = 0.5, weight_dtype: torch.dtype = torch.float32,
        budgets: Optional[Sequence[int]] = None, k: int = TOPK) -> State:
    """``iterations`` iterations of the stack (each colony stops at its own
    budget when ``budgets`` is given: its rows are then held)."""
    for i in range(iterations):
        new = iterate(col, st, q, rho, weight_dtype, k)[0]
        if budgets is not None:
            live = torch.tensor([i < b for b in budgets], device=st.tau.device)
            new = State(*(torch.where(
                live.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
                for x, y in zip(new, st)))
        st = new
    return st
