"""CUDA kernels: the dense fused construction (choice -> select).

Replaces ``repro/kernels/fused_select.py::fused_select`` (``_fused_kernel``,
``pallas_call`` at fused_select.py:176) and the reference's ``lax.scan``
over it (``repro/core/strategies.py`` ``_construct`` with
``_make_fused_step``).  Source: ``csrc/fused_select.cu``.

- ``fused_walk`` / ``fused_walk_quant``: the whole construction of one
  iteration in one launch (float32 tau, K1; an int8 or bfloat16 payload
  dequantised in registers, the Pallas kernel's ``quant`` epilogue, K6).
  One block owns one ant for all n-1 steps; the step's threefry draw is
  hashed in registers, only at the cities where its value can change the
  pick.  Bound on the H100: operations, one threefry hash (about 80 integer
  operations) per (step, ant, selectable city): about 2.4 ms at
  n = m = 1002, where its bytes (payload, eta, tours) take 2.7-4 us.  This
  is what the dense kernel route launches, once an iteration.  With a
  leading instance axis (the reference's ``pallas_call`` under ``vmap``)
  one launch walks a (B, n, n) stack: B·m blocks, each instance's
  ``n_actual`` from a (B,) device array, an inactive instance skipped; the
  single walk is its B = 1 case, one kernel body.
- ``fused_select`` / ``fused_select_quant``: one step for m ants, over a
  draw tensor built outside, with the reference kernel's own signature.
  Bound: bytes, about 13 MB per step at n = m = 1002 (3.9 us).  Kept and
  checked on the card; no path launches it any more.

``fused_walk_plain`` is the walk as the host loop of plain steps
(``fold_in`` -> the step's (m, n) draw -> ``fused_select_plain`` -> tabu
update), over a stack a loop over its instances: the CPU path of
``ops.fused_walk`` and the yardstick of the walk kernel on the card.
``fused_select_plain`` and ``fused_select_quant_plain`` are the one-step
functions in plain PyTorch; the quantised one dequantises the whole matrix
first (the reference's oracle), and the per-row scale is constant along a
row, so that multiplies exactly the operands the kernels do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import sampling
from ..core.quant import dequantise_rows
from . import _build
from .choice_info import ipow
from .sparse_select import DRAW_CODES, DRAW_MAX, DRAW_MIN
from .tour_select import mode_code, tour_select_plain


def fused_select_plain(tau: torch.Tensor, eta: torch.Tensor,
                       cur: torch.Tensor, visited: torch.Tensor,
                       rand: torch.Tensor, alpha: float = 1.0,
                       beta: float = 2.0, n_actual: Optional[int] = None,
                       mode: str = "iroulette") -> torch.Tensor:
    """Gather rows ``cur`` of tau/eta, weight, mask, select -> (m,) int32."""
    c = cur.long()
    rows = ipow(tau[c], alpha) * ipow(eta[c], beta)
    return tour_select_plain(rows, visited, rand, mode, n_actual)


def fused_select_quant_plain(tau_q: torch.Tensor,
                             tau_scale: Optional[torch.Tensor],
                             eta: torch.Tensor, cur: torch.Tensor,
                             visited: torch.Tensor, rand: torch.Tensor,
                             alpha: float = 1.0, beta: float = 2.0,
                             n_actual: Optional[int] = None,
                             mode: str = "iroulette") -> torch.Tensor:
    """Dequantise the whole payload, then ``fused_select_plain``."""
    return fused_select_plain(dequantise_rows(tau_q, tau_scale), eta, cur,
                              visited, rand, alpha, beta, n_actual, mode)


def _check_selection(tau, eta, cur, visited, rand):
    m, n = visited.shape
    dev = tau.device
    if tau.shape[1] != n:
        raise ValueError(f"fused_select: tau has {tau.shape[1]} columns, "
                         f"visited {n}")
    _build.require("fused_select eta", eta, torch.float32, tau.shape, dev)
    _build.require("fused_select cur", cur, torch.int32, (m,), dev)
    _build.require("fused_select visited", visited,
                   (torch.bool, torch.uint8, torch.int8), None, dev)
    _build.require("fused_select rand", rand, torch.float32, (m, n), dev)


def fused_select(tau: torch.Tensor, eta: torch.Tensor, cur: torch.Tensor,
                 visited: torch.Tensor, rand: torch.Tensor,
                 alpha: float = 1.0, beta: float = 2.0,
                 n_actual: Optional[int] = None,
                 mode: str = "iroulette") -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else.

    tau/eta (R, n); cur (m,) int32 in [0, R); visited/rand (m, n).
    """
    code = mode_code(mode)
    m, n = visited.shape
    dev = tau.device
    _build.require("fused_select tau", tau, torch.float32)
    _check_selection(tau, eta, cur, visited, rand)
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("fused_select", dev, tau.data_ptr(), eta.data_ptr(),
                  tau.shape[0], cur.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), out.data_ptr(), m, n, float(alpha),
                  float(beta), code, n_act)
    _build.count(fused_select)
    return out


fused_select.launches = 0


def fused_select_quant(tau_q: torch.Tensor, tau_scale: Optional[torch.Tensor],
                       eta: torch.Tensor, cur: torch.Tensor,
                       visited: torch.Tensor, rand: torch.Tensor,
                       alpha: float = 1.0, beta: float = 2.0,
                       n_actual: Optional[int] = None,
                       mode: str = "iroulette") -> torch.Tensor:
    """Launch the kernel over an int8 (with its (R, 1) float32
    ``tau_scale``) or bfloat16 payload on CUDA tensors; raises on anything
    else."""
    code = mode_code(mode)
    m, n = visited.shape
    dev = tau_q.device
    _build.require("fused_select_quant tau", tau_q,
                   (torch.int8, torch.bfloat16))
    _check_selection(tau_q, eta, cur, visited, rand)
    scale_ptr = None
    if tau_q.dtype == torch.int8:
        if tau_scale is None:
            raise ValueError("fused_select_quant: an int8 payload needs its "
                             "per-row scale")
        _build.require("fused_select_quant scale", tau_scale, torch.float32,
                       (tau_q.shape[0], 1), dev)
        scale_ptr = tau_scale.data_ptr()
    n_act = n if n_actual is None else int(n_actual)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _build.launch("fused_select_quant", dev, tau_q.data_ptr(),
                  1 if tau_q.dtype == torch.int8 else 2, scale_ptr,
                  eta.data_ptr(), tau_q.shape[0], cur.data_ptr(),
                  visited.data_ptr(), rand.data_ptr(), out.data_ptr(), m, n,
                  float(alpha), float(beta), code, n_act)
    _build.count(fused_select_quant)
    return out


fused_select_quant.launches = 0


# ------------------------------------------------------------ the walk

def fused_walk_plain(tau: torch.Tensor, eta: torch.Tensor,
                     start: torch.Tensor, key: torch.Tensor,
                     alpha: float = 1.0, beta: float = 2.0,
                     n_actual=None,
                     mode: str = "iroulette", draw_mode: str = "packed",
                     tau_scale: Optional[torch.Tensor] = None,
                     visited: Optional[torch.Tensor] = None,
                     first_step: int = 1, select=None,
                     active: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """The walk as a host loop of plain steps, on any device.  Same
    arguments and result as ``fused_walk`` (a quantised ``tau`` payload
    with its int8 ``tau_scale`` as in ``fused_walk_quant``).  Step t draws
    the full (m, n) uniform of ``fold_in(key, t)``.  ``select`` replaces
    the plain selection of a step (``ops.fused_select``'s signature, given
    the payload as it came): the one-step kernel route this walk replaced,
    for timing beside it.  A (B, R, n) ``tau`` is a stack of instances: a
    loop of single walks over the active ones, the rows of an inactive one
    left at zero."""
    if tau.dim() == 3:
        nb = tau.shape[0]
        out = torch.zeros((nb, max(tau.shape[2] - first_step, 0),
                           start.shape[-1]), dtype=torch.int32,
                          device=start.device)
        acts = [True] * nb if active is None else list(active)
        for b, n_act in enumerate(_build.slot_ints(n_actual, nb)):
            if acts[b]:
                out[b] = fused_walk_plain(
                    tau[b], eta[b], start[b], key[b], alpha, beta, n_act,
                    mode, draw_mode,
                    None if tau_scale is None else tau_scale[b],
                    None if visited is None else visited[b], first_step,
                    select)
        return out
    from ..core.strategies import _draw_step_uniform
    mode_code(mode)
    if draw_mode not in DRAW_CODES:
        raise ValueError(f"fused_walk: unknown draw_mode {draw_mode!r}")
    m, n = start.shape[0], tau.shape[1]
    dev = start.device
    ants = torch.arange(m, device=dev)
    vis = (torch.zeros((m, n), dtype=torch.bool, device=dev)
           if visited is None else visited.clone())
    vis[ants, start.long()] = True
    scale = tau_scale if tau.dtype == torch.int8 else None
    if select is None:
        tau_f = dequantise_rows(tau, scale)

        def select(tau, eta, cur, visited, rand, alpha, beta, n_actual,
                   mode, tau_scale=None):
            return fused_select_plain(tau_f, eta, cur, visited, rand, alpha,
                                      beta, n_actual, mode)

    out = torch.empty((max(n - first_step, 0), m), dtype=torch.int32,
                      device=dev)
    keys = sampling.fold_in(key, torch.arange(first_step, n, device=dev))
    cur = start
    for t in range(first_step, n):
        if n_actual is not None and t >= n_actual:
            # the phantom tail in fixed index order, as the reference
            nxt = torch.full((m,), t, dtype=torch.int32, device=dev)
        else:
            u = _draw_step_uniform(keys[t - first_step], (m, n), draw_mode)
            nxt = select(tau, eta, cur, vis, u, alpha, beta, n_actual, mode,
                         tau_scale=scale)
        vis[ants, nxt.long()] = True
        out[t - first_step] = nxt
        cur = nxt
    return out


def _launch_walk(name: str, tau: torch.Tensor, scale, eta: torch.Tensor,
                 start: torch.Tensor, key: torch.Tensor, alpha: float,
                 beta: float, n_actual, mode: str, draw_mode: str,
                 visited: Optional[torch.Tensor], first_step: int,
                 active: Optional[Sequence[bool]]) -> torch.Tensor:
    """One launch for one instance ((R, n) tau) or a stack of B ((B, R, n)
    tau, the leading axis on every operand); returns the picked cities and
    the number of instances walked."""
    code = mode_code(mode)
    if draw_mode not in DRAW_CODES:
        raise ValueError(f"{name}: unknown draw_mode {draw_mode!r}")
    lead = tuple(tau.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"{name}: tau must be (R, n) or (B, R, n)")
    nb = lead[0] if lead else 1
    n_rows, n = tau.shape[-2:]
    dev = tau.device
    _build.require(f"{name} eta", eta, torch.float32, tau.shape, dev)
    m = start.shape[-1]
    _build.require(f"{name} start", start, torch.int32, lead + (m,), dev)
    _build.require(f"{name} key", key, torch.int64, lead + (2,), dev)
    if visited is not None:
        _build.require(f"{name} visited", visited, torch.bool,
                       lead + (m, n), dev)
    # every instance's plane of the payload and of eta on a 16-byte
    # boundary: the stack is never copied to make it so
    plane = n_rows * n
    if (tau.data_ptr() | eta.data_ptr()) % 16 or (
            nb > 1 and (plane * tau.dtype.itemsize | plane * 4) % 16):
        raise ValueError(f"{name}: tau and eta must be 16-byte aligned, "
                         "every instance of a stack")
    if draw_mode == "counter" and n > sampling.COUNTER_STRIDE:
        raise ValueError(f"{name}: counter draws need n <= "
                         f"{sampling.COUNTER_STRIDE}, got {n}")
    if first_step < 1:
        raise ValueError(f"{name}: first_step {first_step} < 1")
    # a (B,) tensor is read on the card only: the caller has checked its
    # values (colony_step_batch does)
    n_act, n_act_ptr = _build.n_actual_arg(name, n_actual, nb, n, dev)
    flags, walked = _build.active_flags(active, nb, dev)
    # the quantised entry takes the payload kind and the int8 scale first
    payload = () if name == "fused_walk" else (
        1 if tau.dtype == torch.int8 else 2,
        None if scale is None else scale.data_ptr())
    shape = lead + (max(n - first_step, 0), m)
    out = (torch.empty(shape, dtype=torch.int32, device=dev) if flags is None
           else torch.zeros(shape, dtype=torch.int32, device=dev))
    span = sampling.uniform_span(draw_mode, DRAW_MIN, DRAW_MAX)
    _build.launch(name, dev, tau.data_ptr(), *payload, eta.data_ptr(),
                  n_rows, start.data_ptr(),
                  None if visited is None else visited.data_ptr(),
                  key.data_ptr(), out.data_ptr(), nb, m, n, int(first_step),
                  float(alpha), float(beta), code, DRAW_CODES[draw_mode],
                  DRAW_MIN, span, n_act, n_act_ptr,
                  None if flags is None else flags.data_ptr())
    return out, walked


def fused_walk(tau: torch.Tensor, eta: torch.Tensor, start: torch.Tensor,
               key: torch.Tensor, alpha: float = 1.0, beta: float = 2.0,
               n_actual=None, mode: str = "iroulette",
               draw_mode: str = "packed",
               visited: Optional[torch.Tensor] = None,
               first_step: int = 1,
               active: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Launch the walk kernel on CUDA tensors; raises on anything else.

    tau/eta (R, n) float32, 16-byte aligned; ``start`` (m,) int32, the
    ants' first cities; ``key`` (2,) int64, the construction key (step t
    draws from ``fold_in(key, t)``).  The ants' tabu rows start from
    ``visited`` (m, n) bool, or clear, with each start city marked.  Runs
    steps t = first_step .. n-1; steps t >= n_actual emit city t.  Returns
    the picked cities, (n - first_step, m) int32.  The kernel reads each
    row in 16-byte chunks aligned in the flat array: a chunk that holds one
    element of a row lies in that array's 16-byte granule.

    The instance axis: a (B, R, n) tau walks B instances in one launch,
    every operand with the leading B (start (B, m), key (B, 2), visited
    (B, m, n)), ``n_actual`` a host int or a (B,) int32 tensor on the card
    whose values the caller has checked to lie in [1, n], ``active`` B host
    flags (None: all).  Each instance is bitwise its own single launch; an
    inactive one costs no walk and its rows of the (B, n - first_step, m)
    result are zero.  ``launches`` counts launches, ``slot_launches`` the
    instances they walked."""
    _build.require("fused_walk tau", tau, torch.float32)
    out, walked = _launch_walk("fused_walk", tau, None, eta, start, key,
                               alpha, beta, n_actual, mode, draw_mode,
                               visited, first_step, active)
    _build.count(fused_walk, walked)
    return out


fused_walk.launches = 0
fused_walk.slot_launches = 0


def fused_walk_quant(tau_q: torch.Tensor, tau_scale: Optional[torch.Tensor],
                     eta: torch.Tensor, start: torch.Tensor,
                     key: torch.Tensor, alpha: float = 1.0,
                     beta: float = 2.0, n_actual=None,
                     mode: str = "iroulette", draw_mode: str = "packed",
                     visited: Optional[torch.Tensor] = None,
                     first_step: int = 1,
                     active: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """``fused_walk`` over an int8 (with its (R, 1) float32 ``tau_scale``,
    (B, R, 1) for a stack) or bfloat16 payload on CUDA tensors; raises on
    anything else."""
    _build.require("fused_walk_quant tau", tau_q,
                   (torch.int8, torch.bfloat16))
    scale = None
    if tau_q.dtype == torch.int8:
        if tau_scale is None:
            raise ValueError("fused_walk_quant: an int8 payload needs its "
                             "per-row scale")
        _build.require("fused_walk_quant scale", tau_scale, torch.float32,
                       tuple(tau_q.shape[:-1]) + (1,), tau_q.device)
        scale = tau_scale
    out, walked = _launch_walk("fused_walk_quant", tau_q, scale, eta, start,
                               key, alpha, beta, n_actual, mode, draw_mode,
                               visited, first_step, active)
    _build.count(fused_walk_quant, walked)
    return out


fused_walk_quant.launches = 0
fused_walk_quant.slot_launches = 0
