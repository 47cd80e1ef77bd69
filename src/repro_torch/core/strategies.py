"""Tour construction (paper §IV.A), the PyTorch port of ``repro.core.strategies``.

Three construction methods of the reference's ladder are ported:

- ``data_parallel``  the paper's contribution: the colony's step is one
                     (m, n) tensor op -- gather choice rows, mask tabu,
                     select (``sampling`` selectors);
- ``pallas``         the paper's unfused kernel pair: rows of a
                     precomputed choice matrix go through the ``tour_select``
                     kernel (``kernels/tour_select.py``);
- ``fused``          the ``fused_select`` kernel (``kernels/fused_select.py``):
                     row gather, ``tau^alpha * eta^beta``, masking and
                     selection in one launch, with no (n, n) choice matrix.

The reference's ``lax.scan`` over the n-1 steps is a Python loop here: step
``t`` draws from ``fold_in(key, t)``.  Padded instances (``n_actual``) emit
the phantom tail in fixed index order, as the reference does.  The other
methods (``task_baseline``, ``task_choice``, ``nn_list``) are not ported
yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..kernels.choice_info import ipow
from . import sampling, tsp

NActual = Union[int, None]


class TourState(NamedTuple):
    cur: torch.Tensor      # (m,) int32 current city
    visited: torch.Tensor  # (m, n) bool tabu list


class TourResult(NamedTuple):
    tours: torch.Tensor    # (m, n) int32 city permutations
    lengths: torch.Tensor  # (m,) float32 closed-tour lengths


METHODS = ("data_parallel", "pallas", "fused")


def place_ants(key: torch.Tensor, m: int, n: int,
               n_actual: NActual = None) -> torch.Tensor:
    """Random initial city per ant, bounded to the real cities."""
    hi = n if n_actual is None else n_actual
    return sampling.randint(key, (m,), 0, hi)


def _init_state(start: torch.Tensor, n: int) -> TourState:
    m = start.shape[0]
    visited = torch.zeros((m, n), dtype=torch.bool, device=start.device)
    visited[torch.arange(m, device=start.device), start.long()] = True
    return TourState(start, visited)


def _finish(start: torch.Tensor, steps: list, dist: torch.Tensor,
            n_actual: NActual = None) -> TourResult:
    """steps: n-1 emitted (m,) city vectors -> tours (m, n) + lengths."""
    tours = torch.stack([start] + steps, dim=0).T.contiguous()
    tours = tours.to(torch.int32)
    return TourResult(tours, tsp.tour_length(dist, tours, n_actual))


StepImpl = Callable[[torch.Tensor, torch.Tensor, TourState, int, dict],
                    torch.Tensor]
# (key, choice_info, state, t, extras) -> next city (m,)


def _make_dense_step(selector: str, draw_mode: str = "packed") -> StepImpl:
    sel = sampling.get_selector(selector, draw_mode)

    def step(key, choice_info, st, t, extras):
        del t, extras
        w = choice_info[st.cur.long()] * (~st.visited)          # (m, n)
        return sel(key, w)

    return step


def _draw_step_uniform(key: torch.Tensor, shape: tuple,
                       draw_mode: str) -> torch.Tensor:
    """The per-(ant, city) U(1e-6, 1) tensor the kernel steps consume."""
    if draw_mode == "counter":
        return sampling.counter_uniform(key, shape, minval=1e-6, maxval=1.0)
    return sampling.uniform(key, shape, minval=1e-6, maxval=1.0)


def _make_pallas_step(selector: str, draw_mode: str = "packed") -> StepImpl:
    def step(key, choice_info, st, t, extras):
        del t
        from ..kernels import ops as kops
        rows = choice_info[st.cur.long()]
        u = _draw_step_uniform(key, tuple(rows.shape), draw_mode)
        return kops.tour_select(rows, st.visited, u, selector,
                                extras["n_actual"])

    return step


def _make_fused_step(selector: str, alpha: float, beta: float,
                     draw_mode: str = "packed") -> StepImpl:
    def step(key, choice_info, st, t, extras):
        del choice_info, t
        from ..kernels import ops as kops
        u = _draw_step_uniform(key, tuple(st.visited.shape), draw_mode)
        return kops.fused_select(extras["tau"], extras["eta"], st.cur,
                                 st.visited, u, alpha, beta,
                                 extras["n_actual"], selector)

    return step


def construct_tours(
    key: torch.Tensor,
    dist: torch.Tensor,
    choice_info: Optional[torch.Tensor],
    m: int,
    method: str = "data_parallel",
    selection: str = "iroulette",
    tau: Optional[torch.Tensor] = None,
    eta: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    beta: float = 2.0,
    n_actual: NActual = None,
    draw_mode: str = "packed",
) -> TourResult:
    """Build m complete tours under the given method.

    choice_info: (n, n) precomputed tau^alpha * eta^beta (ignored by
    ``fused``, which needs ``tau``/``eta`` and host-float ``alpha``/``beta``).
    ``n_actual``: real-city count of a padded instance (host int), or None.
    """
    if method not in METHODS:
        if method in ("task_choice", "task_baseline", "nn_list",
                      "nn_list_eager"):
            raise NotImplementedError(
                f"construction {method!r} is not ported yet (ROADMAP queue 1 "
                f"item 5); ported: {', '.join(METHODS)}")
        raise ValueError(f"unknown construction method {method}")
    if draw_mode not in sampling.DRAW_MODES:
        raise ValueError(f"unknown draw_mode {draw_mode!r}; "
                         f"supported: {', '.join(sampling.DRAW_MODES)}")
    n = dist.shape[0]
    if method == "fused":
        assert tau is not None and eta is not None
        step_impl = _make_fused_step(selection, float(alpha), float(beta),
                                     draw_mode)
    elif method == "pallas":
        step_impl = _make_pallas_step(selection, draw_mode)
    else:
        step_impl = _make_dense_step(selection, draw_mode)
    kp, kc = sampling.split(key)
    start = place_ants(kp, m, n, n_actual)
    extras = {"tau": tau, "eta": eta, "n_actual": n_actual}
    st = _init_state(start, n)
    ants = torch.arange(m, device=dist.device)
    # One batched hash gives every step's key: fold_in(kc, t), t = 1..n-1.
    step_keys = sampling.fold_in(kc, torch.arange(1, n, device=kc.device))
    steps = []
    for t in range(1, n):
        if n_actual is not None and t >= n_actual:
            # Padded instance: the real cities are exhausted, emit the
            # phantom tail in fixed index order (the reference computes
            # and discards a selection here; its draws feed nothing).
            nxt = torch.full((m,), t, dtype=torch.int32, device=dist.device)
        else:
            nxt = step_impl(step_keys[t - 1], choice_info, st, t, extras)
        st.visited[ants, nxt.long()] = True      # in place: one (m, n) buffer
        st = TourState(nxt, st.visited)
        steps.append(nxt)
    return _finish(start, steps, dist, n_actual)


def choice_matrix(tau: torch.Tensor, eta: torch.Tensor, alpha: float,
                  beta: float) -> torch.Tensor:
    """The paper's Choice kernel on the pure route: tau^a * eta^b, with
    integer exponents up to 4 folded into repeated products (the same
    folding as the ``choice_info`` kernel)."""
    return ipow(tau, alpha) * ipow(eta, beta)
