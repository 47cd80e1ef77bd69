"""Batched local search, the PyTorch port of ``repro.core.localsearch``:
NN-restricted 2-opt and Or-opt over all m ant tours at once.

- **2-opt**: for every tour position ``i`` (city ``a``, successor ``a'``)
  and every candidate ``c`` in ``nn[a]`` (position ``j``, successor
  ``c'``), the move replaces edges (a, a') and (c, c') with (a, c) and
  (a', c') by reversing the segment between them.  The n * k deltas per
  ant form one (m, n * k) tensor; each round applies one best (or first)
  improving move per ant.  The reduction is the ``two_opt_best`` kernel
  on the kernel route (``use_pallas``) and its plain version otherwise;
  the operand gathers are plain PyTorch on both routes, as in the
  reference.
- **Or-opt**: segments of length 1..seg_max move to just after a candidate
  from ``nn[s0]``; the move is applied with a fractional sort key and a
  stable argsort.

A move is applied only when its delta is below ``-min_delta``, and moves
that share an edge with the tour are masked, so no round makes a tour
longer.  The reference's bounded ``lax.while_loop`` is a host loop here
with the same exit rule (at most ``rounds`` rounds, stop once no tour
changed); ``improve.rounds`` counts the rounds run, across calls.

Every function takes one instance ((m, n) tours, (n, n) ``dist``, (n, k)
``nn``, a host int ``n_actual``) or a stack of B ((B, m, n) tours, (B, n,
n) ``dist``, (B, n, k) ``nn``, a (B,) int32 ``n_actual`` tensor): the
reference's local search under ``vmap``.  A stack's 2-opt moves fold into
(B * m, n * k) rows for one reduction a round, and its rounds go on while
any instance's tours changed: a round that changes nothing is a fixed
point, so each instance ends bitwise where its own loop would.
``slots_per_pass`` sizes a stack from the card's free memory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import torch

from ..kernels import two_opt as _two_opt
from . import floatops, tsp

NActual = Union[int, torch.Tensor, None]

# Device bytes one 2-opt or Or-opt round holds per (ant, position,
# candidate) move at its peak: the int64 candidate and successor indices,
# the int32 positions, four float32 operands and the mask, with the
# temporaries of their gathers (chip_smoke.py [batched] checks it).
BYTES_PER_MOVE = 64


@dataclasses.dataclass(frozen=True)
class LocalSearchConfig:
    kind: str = "2opt"           # none | 2opt | oropt | 2opt_oropt
    rounds: int = 24             # at most this many improvement rounds
    improvement: str = "best"    # best | first (move choice per round)
    seg_max: int = 3             # Or-opt max relocated-segment length
    # A move is applied only when delta < -min_delta (absolute tour-length
    # units), so float cancellation never applies a zero-gain move.
    min_delta: float = 1e-3
    use_pallas: bool = False     # 2-opt reduction via the two_opt_best kernel


class Move(NamedTuple):
    delta: torch.Tensor  # (..., m) best/first move delta (1e30 when none)
    i: torch.Tensor      # (..., m) tour position of the move anchor
    j: torch.Tensor      # (..., m) tour position of the candidate endpoint


def _cities(mat: torch.Tensor, i: torch.Tensor,
            j: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mat[i]`` (or ``mat[i, j]``) of each tour's own instance: ``mat``
    (n, ...) for one instance, or a (B, n, ...) stack (``dist`` (B, n, n),
    ``nn`` (B, n, k)) whose index tensors lead with the same B."""
    if mat.dim() == 3:
        b = torch.arange(mat.shape[0], device=i.device).reshape(
            (-1,) + (1,) * (i.dim() - 1))
        return mat[b, i] if j is None else mat[b, i, j]
    return mat[i] if j is None else mat[i, j]


def tour_positions(tours: torch.Tensor) -> torch.Tensor:
    """pos[..., ant, city] = position of city in that ant's tour."""
    n = tours.shape[-1]
    steps = torch.arange(n, dtype=torch.int32,
                         device=tours.device).expand(tours.shape)
    return torch.zeros(tours.shape, dtype=torch.int32,
                       device=tours.device).scatter_(-1, tours.long(), steps)


def _successors(tours: torch.Tensor, n_actual: NActual) -> torch.Tensor:
    """succ[..., ant, p] = city after position p.  With ``n_actual`` the
    real tour closes at position n_actual-1 back to position 0; phantom-tail
    successors are garbage the caller masks."""
    succ = torch.roll(tours, -1, dims=-1)
    if n_actual is not None:
        idx = torch.arange(tours.shape[-1], device=tours.device)
        last = tsp.per_slot(n_actual, tours.dim()) - 1
        succ = torch.where(idx == last, tours[..., :1], succ)
    return succ


def _gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, index.reshape(..., m, -1), -1)`` back in
    index's shape."""
    return torch.gather(x, -1, index.reshape(x.shape[:-1] + (-1,)).long()
                        ).reshape(index.shape)


# --------------------------------------------------------------------------
# 2-opt
# --------------------------------------------------------------------------

def _two_opt_operands(dist: torch.Tensor, nn: torch.Tensor,
                      tours: torch.Tensor, n_actual: NActual = None):
    """Gathered distance tensors for all (position, candidate) 2-opt moves:
    (add1, add2, rem1, rem2, valid, j), each (..., m, n, k).  The move at
    (ant, i, c) removes edges (a, a') and (c, c') and adds (a, c),
    (a', c')."""
    n = tours.shape[-1]
    pos = tour_positions(tours)
    a = tours.long()
    succ = _successors(tours, n_actual)
    a_nxt = succ.long()
    c = _cities(nn, a).long()                        # (..., m, n, k)
    j = _gather(pos, c)
    c_nxt = _gather(succ, j).long()
    add1 = _cities(dist, a[..., None], c)            # d(a, c)
    add2 = _cities(dist, a_nxt[..., None], c_nxt)    # d(a', c')
    rem1 = _cities(dist, a, a_nxt)[..., None].expand(add1.shape)
    rem2 = _cities(dist, c, c_nxt)
    # A move sharing an edge with the tour has a true delta of 0, which
    # float cancellation could make negative: mask it.
    valid = (c != a_nxt[..., None]) & (c_nxt != a[..., None])
    if n_actual is not None:
        # padded instance: anchors in the real prefix, real candidates only
        na = tsp.per_slot(n_actual, c.dim())
        i_pos = torch.arange(n, device=tours.device)[:, None]
        valid = valid & (i_pos < na) & (c < na)
    return add1, add2, rem1, rem2, valid, j


def _reduce_moves(add1, add2, rem1, rem2, valid, cfg: LocalSearchConfig):
    """(..., m, n, k) move operands -> per-ant (delta, flat move index),
    (..., m): a stack's moves fold into its (B * m, n * k) rows, one
    reduction for every ant of every instance."""
    lead = tuple(add1.shape[:-2])
    flat = [x.reshape(-1, x.shape[-2] * x.shape[-1])
            for x in (add1, add2, rem1, rem2, valid)]
    if cfg.use_pallas:
        from ..kernels import ops as kops
        val, idx = kops.two_opt_best(*flat, thr=cfg.min_delta,
                                     mode=cfg.improvement)
    else:
        val, idx = _two_opt.two_opt_best_plain(*flat, thr=cfg.min_delta,
                                               mode=cfg.improvement)
    return val.reshape(lead), idx.reshape(lead)


def _pick(flat_idx: torch.Tensor, at: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """A flat (position, candidate) move index -> (position, ``at`` of the
    move), ``at`` (..., m, n, k)."""
    n = at.shape[-2]
    safe = torch.clamp(flat_idx.long(), 0, n * k - 1)
    p = torch.div(safe, k, rounding_mode="floor").to(torch.int32)
    q = torch.gather(at.reshape(at.shape[:-2] + (-1,)), -1,
                     safe[..., None])[..., 0]
    return p, q


def best_two_opt_move(dist: torch.Tensor, nn: torch.Tensor,
                      tours: torch.Tensor, cfg: LocalSearchConfig,
                      n_actual: NActual = None) -> Move:
    add1, add2, rem1, rem2, valid, j = _two_opt_operands(
        dist, nn, tours, n_actual)
    val, idx = _reduce_moves(add1, add2, rem1, rem2, valid, cfg)
    return Move(val, *_pick(idx, j, j.shape[-1]))


def apply_two_opt(tours: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                  do: torch.Tensor) -> torch.Tensor:
    """Reverse positions (min(i,j), max(i,j)] per ant where ``do`` holds."""
    n = tours.shape[-1]
    lo = torch.minimum(i, j)[..., None]
    hi = torch.maximum(i, j)[..., None]
    idx = torch.arange(n, dtype=torch.int32, device=tours.device)
    within = (idx > lo) & (idx <= hi)
    src = torch.where(within, lo + 1 + hi - idx, idx)
    src = torch.where(do[..., None], src, idx)
    return torch.gather(tours, -1, src.long())


def two_opt_round(dist: torch.Tensor, nn: torch.Tensor, tours: torch.Tensor,
                  cfg: LocalSearchConfig,
                  n_actual: NActual = None) -> torch.Tensor:
    mv = best_two_opt_move(dist, nn, tours, cfg, n_actual)
    # masked moves have i, j < n_actual: the phantom tail is never touched
    return apply_two_opt(tours, mv.i, mv.j,
                         mv.delta < floatops.const(-cfg.min_delta, mv.delta))


# --------------------------------------------------------------------------
# Or-opt (segment relocation)
# --------------------------------------------------------------------------

def best_or_opt_move(dist: torch.Tensor, nn: torch.Tensor,
                     tours: torch.Tensor, seg_len: int,
                     cfg: LocalSearchConfig,
                     n_actual: NActual = None) -> Move:
    """Best (or first) relocation of a ``seg_len`` segment, candidates from
    nn[s0].  Move (ant, p, c): remove the segment at positions
    [p, p+seg_len-1] and insert it between c and c's successor;
    delta = d(prev,next) + d(c,s0) + d(s_end,c') - d(prev,s0)
    - d(s_end,next) - d(c,c'), summed in that order."""
    n = tours.shape[-1]
    dev = tours.device
    pos = tour_positions(tours)
    s0 = tours.long()
    s_end = torch.roll(tours, -(seg_len - 1), dims=-1).long()
    c = _cities(nn, s0).long()                       # (..., m, n, k)
    k = c.shape[-1]
    q = _gather(pos, c)
    idx = torch.arange(n, device=dev)
    if n_actual is None:
        prev = torch.roll(tours, 1, dims=-1)
        nxt = torch.roll(tours, -seg_len, dims=-1)
        c_nxt = _gather(tours, (q + 1) % n)
        n_lim = n
    else:
        # padded tour: wrap within the real prefix [0, n_actual) only
        na = tsp.per_slot(n_actual, tours.dim())
        succ = _successors(tours, n_actual)
        if isinstance(na, torch.Tensor):
            last = torch.gather(tours, -1, (na - 1).long().expand(
                tours.shape[:-1] + (1,)))
        else:
            last = tours[..., na - 1:na]
        prev = torch.where(idx == 0, last, torch.roll(tours, 1, dims=-1))
        nxt = torch.gather(tours, -1, ((idx + seg_len) % na)
                           .expand(tours.shape).long())
        c_nxt = _gather(succ, q)
        n_lim = tsp.per_slot(n_actual, c.dim())
    prev, nxt, c_nxt = prev.long(), nxt.long(), c_nxt.long()
    delta = (
        _cities(dist, prev, nxt)[..., None] + _cities(dist, s0[..., None], c)
        + _cities(dist, s_end[..., None], c_nxt)
        - _cities(dist, prev, s0)[..., None]
        - _cities(dist, s_end, nxt)[..., None]
        - _cities(dist, c, c_nxt)
    )
    p = idx[:, None]
    in_seg = (q >= p) & (q < p + seg_len)
    valid = (~in_seg) & (c != prev[..., None]) & (p <= n_lim - seg_len)
    if n_actual is not None:
        valid = valid & (c < n_lim)
    lead = tuple(tours.shape[:-1])
    val, idx_sel = _two_opt.select_move(
        delta.reshape(-1, n * k), valid.reshape(-1, n * k),
        thr=cfg.min_delta, mode=cfg.improvement)
    return Move(val.reshape(lead), *_pick(idx_sel.reshape(lead), q, k))


def apply_or_opt(tours: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                 seg_len: int, do: torch.Tensor) -> torch.Tensor:
    """Relocate the segment at [p, p+seg_len) to just after position q:
    segment cities get sort keys strictly between q and q+1, every other
    city keeps its position, and a stable argsort splices."""
    n = tours.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=tours.device)
    in_seg = (idx >= p[..., None]) & (idx < p[..., None] + seg_len)
    off = (idx - p[..., None]).to(torch.float32)
    pos_key = idx.to(torch.float32)
    one = floatops.const(1.0, off)
    key = torch.where(in_seg,
                      q[..., None].to(torch.float32)
                      + (off + one) / floatops.const(seg_len + 1.0, off),
                      pos_key)
    key = torch.where(do[..., None], key, pos_key)
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(tours, -1, order)


def or_opt_round(dist: torch.Tensor, nn: torch.Tensor, tours: torch.Tensor,
                 cfg: LocalSearchConfig,
                 n_actual: NActual = None) -> torch.Tensor:
    for seg_len in range(1, min(cfg.seg_max, tours.shape[-1] - 2) + 1):
        mv = best_or_opt_move(dist, nn, tours, seg_len, cfg, n_actual)
        tours = apply_or_opt(
            tours, mv.i, mv.j, seg_len,
            mv.delta < floatops.const(-cfg.min_delta, mv.delta))
    return tours


# --------------------------------------------------------------------------
# Improvement loop + registry
# --------------------------------------------------------------------------

def _round_2opt_oropt(dist, nn, tours, cfg, n_actual=None):
    return or_opt_round(dist, nn,
                        two_opt_round(dist, nn, tours, cfg, n_actual), cfg,
                        n_actual)


def _round_none(dist, nn, tours, cfg, n_actual=None):
    del dist, nn, cfg, n_actual
    return tours


RoundFn = Callable[..., torch.Tensor]

# name -> one-improvement-round function
STRATEGIES: dict[str, RoundFn] = {
    "none": _round_none,
    "2opt": two_opt_round,
    "oropt": or_opt_round,
    "2opt_oropt": _round_2opt_oropt,
}


def improve(dist: torch.Tensor, nn: torch.Tensor, tours: torch.Tensor,
            cfg: LocalSearchConfig,
            n_actual: NActual = None) -> torch.Tensor:
    """Run up to ``cfg.rounds`` improvement rounds on all tours at once,
    stopping after the first round that changed no tour (of any instance
    of a stack).  Never worsens a tour; with ``n_actual`` moves stay in the
    real prefix.  Each round reads one flag back to the host."""
    if cfg.kind not in STRATEGIES:
        raise ValueError(
            f"unknown local-search strategy {cfg.kind!r}; "
            f"expected one of {tuple(STRATEGIES)}")
    if cfg.kind == "none" or cfg.rounds <= 0 or tours.shape[-1] < 4:
        return tours
    round_fn = STRATEGIES[cfg.kind]
    r, changed = 0, True
    while r < cfg.rounds and changed:
        t2 = round_fn(dist, nn, tours, cfg, n_actual)
        changed = bool((t2 != tours).any())
        tours, r = t2, r + 1
    improve.rounds += r
    return tours


improve.rounds = 0


def improve_with_lengths(dist: torch.Tensor, nn: torch.Tensor,
                         tours: torch.Tensor, cfg: LocalSearchConfig,
                         n_actual: NActual = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """improve() + recomputed closed-tour lengths."""
    out = improve(dist, nn, tours, cfg, n_actual)
    return out, tsp.tour_length(dist, out, n_actual)


def slots_per_pass(device: torch.device, n_slots: int, m: int, n: int,
                   k: int) -> int:
    """How many instances of a stack one local-search pass takes: all of
    them on the CPU; on the card as many as ``BYTES_PER_MOVE`` per move
    fits in nine tenths of the free memory (the allocator's cached blocks
    included), at least one."""
    if torch.device(device).type != "cuda":
        return n_slots
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    per_slot = m * n * k * BYTES_PER_MOVE
    return max(1, min(n_slots, int(0.9 * free) // per_slot))
