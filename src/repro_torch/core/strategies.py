"""Tour construction (paper §IV.A), the PyTorch port of ``repro.core.strategies``.

The reference's construction ladder (Table II of the paper) and its two
kernel routes:

- ``task_baseline``  one logical thread per ant, ``tau^alpha * eta^beta``
                     recomputed for the current row at every step (the
                     paper's version 1), with ``roulette`` selection;
- ``task_choice``    the same over a precomputed choice matrix (version
                     2): the dense step with ``roulette`` in place of
                     ``iroulette``;
- ``nn_list``        sampling over each ant's nearest-neighbour candidates,
                     with the best unvisited city of the full choice row as
                     the fallback when every candidate is visited (version
                     4).  The fallback is computed only on steps where some
                     ant needs it (one flag read a step); ``nn_list_eager``
                     computes it every step.  The two are bitwise equal;
- ``data_parallel``  the paper's contribution (versions 7/8): the colony's
                     step is one (m, n) tensor op -- gather choice rows,
                     mask tabu, select (``sampling`` selectors);
- ``pallas``         the paper's unfused kernel pair: rows of a
                     precomputed choice matrix go through the ``tour_select``
                     kernel (``kernels/tour_select.py``);
- ``fused``          the ``fused_walk`` kernel (``kernels/fused_select.py``):
                     every step of every ant -- row gather,
                     ``tau^alpha * eta^beta``, the step's draw, masking,
                     selection and tabu update -- in one launch, with no
                     (n, n) choice matrix and no (m, n) draw tensor.

``fused`` and ``pallas`` also take a stack of B instances ((B, 2) keys,
(B, n, n) operands, a (B,) ``n_actual`` tensor, host ``active`` flags):
one walk launch for the batch (``fused``), or one ``tour_select`` launch
per step for the batch (``pallas``), each instance bitwise its own
construction.  The other methods take one instance.

For every method but ``fused`` the reference's ``lax.scan`` over the n-1
steps is a Python loop here, over a stack of one instance or more.  Step
``t`` draws from ``fold_in(key, t)``.  Padded instances (``n_actual``)
emit the phantom tail in fixed index order, as the reference does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from ..kernels.choice_info import ipow
from . import floatops, sampling, tsp

NActual = Union[int, torch.Tensor, None]


class TourState(NamedTuple):
    cur: torch.Tensor      # (..., m) int32 current city
    visited: torch.Tensor  # (..., m, n) bool tabu list


class TourResult(NamedTuple):
    tours: torch.Tensor    # (m, n) int32 city permutations
    lengths: torch.Tensor  # (m,) float32 closed-tour lengths


METHODS = ("data_parallel", "task_choice", "task_baseline", "nn_list",
           "nn_list_eager", "pallas", "fused")
# methods that read a precomputed choice matrix
READS_CHOICE = ("data_parallel", "task_choice", "nn_list", "nn_list_eager",
                "pallas")


def place_ants(key: torch.Tensor, m: int, n: int,
               n_actual: NActual = None) -> torch.Tensor:
    """Random initial city per ant, bounded to the real cities.  A (B, 2)
    stack of keys places (B, m) ants, each instance bounded by its own
    ``n_actual`` (a (B,) tensor)."""
    hi = n if n_actual is None else n_actual
    return sampling.randint(key, (m,), 0, hi)


def _finish(start: torch.Tensor, steps: torch.Tensor, dist: torch.Tensor,
            n_actual: NActual = None) -> TourResult:
    """steps: (n-1, m) int32 emitted cities -> tours (m, n) + lengths; with
    a leading instance axis, (B, n-1, m) -> (B, m, n) + (B, m)."""
    tours = torch.cat([start.unsqueeze(-2), steps], dim=-2)
    tours = tours.transpose(-1, -2).contiguous()
    return TourResult(tours, tsp.tour_length(dist, tours, n_actual))


StepImpl = Callable[[torch.Tensor, torch.Tensor, TourState, dict],
                    torch.Tensor]
# (keys (B, 2), choice_info (B, n, n), state over (B, m), extras)
#   -> next city (B, m)


def _make_dense_step(selector: str, draw_mode: str = "packed") -> StepImpl:
    """The pure route's step: one instance (B = 1)."""
    sel = sampling.get_selector(selector, draw_mode)

    def step(key, choice_info, st, extras):
        del extras
        w = choice_info[0][st.cur[0].long()] * (~st.visited[0])  # (m, n)
        return sel(key[0], w)[None]

    return step


def _make_recompute_step(draw_mode: str = "packed") -> StepImpl:
    """The paper's baseline: ``tau[cur] ** alpha * eta[cur] ** beta``
    recomputed each step, with float32 scalar exponents (the reference's
    are traced, so the general power runs: ``floatops.powf``), then
    ``roulette``."""
    sel = sampling.get_selector("roulette", draw_mode)

    def step(key, choice_info, st, extras):
        del choice_info
        cur = st.cur[0].long()
        w = floatops.powf(extras["tau"][cur], extras["alpha"]) * \
            floatops.powf(extras["eta"][cur], extras["beta"])
        return sel(key[0], w * (~st.visited[0]))[None]

    return step


def _make_nn_step(selector: str, lazy: bool = True,
                  draw_mode: str = "packed") -> StepImpl:
    """NN-list construction: sample among the unvisited candidates of the
    current city's list; where every candidate is visited, the best
    unvisited city by choice value (the full row's first arg-max).
    ``lazy`` computes that fallback only on steps where some ant needs it
    (one flag read a step); otherwise every step.  The fallback is used
    only where ``have`` is false, so both give the same cities."""
    sel = sampling.get_selector(selector, draw_mode)

    def step(key, choice_info, st, extras):
        ci, visited = choice_info[0], st.visited[0]
        cur = st.cur[0].long()
        cand = extras["nn"][cur].long()                     # (m, k)
        cw = ci[cur[:, None], cand]                         # (m, k)
        seen = torch.gather(visited, 1, cand)
        wc = cw * (~seen)
        have = wc.sum(-1) > 0
        local = sel(key[0], wc)                             # (m,) in [0, k)
        nxt = torch.gather(cand, 1, local.long()[:, None])[:, 0].to(
            torch.int32)
        if lazy and bool(have.all()):
            return nxt[None]
        fb = torch.argmax(ci[cur] * (~visited), dim=-1).to(torch.int32)
        return torch.where(have, nxt, fb)[None]

    return step


def _draw_step_uniform(key: torch.Tensor, shape: tuple,
                       draw_mode: str) -> torch.Tensor:
    """The per-(ant, city) U(1e-6, 1) tensor the kernel steps consume; a
    (B, 2) stack of keys gives (B, *shape), row b bitwise key b's draw."""
    if draw_mode == "counter":
        return sampling.counter_uniform(key, shape, minval=1e-6, maxval=1.0)
    return sampling.uniform(key, shape, minval=1e-6, maxval=1.0)


def _make_pallas_step(selector: str, draw_mode: str = "packed") -> StepImpl:
    """The unfused kernel pair's step over a stack: gather each ant's row
    of its instance's choice matrix, draw, one ``tour_select`` launch."""
    def step(key, choice_info, st, extras):
        from ..kernels import ops as kops
        nb, m = st.cur.shape
        bidx = torch.arange(nb, device=st.cur.device)[:, None]
        rows = choice_info[bidx, st.cur.long()]                # (B, m, n)
        u = _draw_step_uniform(key, tuple(rows.shape[1:]), draw_mode)
        return kops.tour_select(rows, st.visited, u, selector,
                                extras["n_actual"], extras["active"])

    return step


def construct_tours(
    key: torch.Tensor,
    dist: torch.Tensor,
    choice_info: Optional[torch.Tensor],
    m: int,
    method: str = "data_parallel",
    selection: str = "iroulette",
    nn: Optional[torch.Tensor] = None,
    tau: Optional[torch.Tensor] = None,
    eta: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    beta: float = 2.0,
    n_actual: NActual = None,
    draw_mode: str = "packed",
    tau_scale: Optional[torch.Tensor] = None,
    active: Optional[Sequence[bool]] = None,
    n_host: Optional[Sequence[int]] = None,
) -> TourResult:
    """Build m complete tours under the given method.

    choice_info: (n, n) precomputed tau^alpha * eta^beta (ignored by
    ``task_baseline``, which needs ``tau``/``eta`` and recomputes its rows
    each step, and by ``fused``, which needs ``tau``/``eta`` and host-float
    ``alpha``/``beta``).  ``nn``: the (n, k) candidate lists of
    ``nn_list``/``nn_list_eager``.
    ``fused`` also takes a quantised ``tau`` payload (int8 or bfloat16,
    ``core/quant.py``); ``tau_scale`` is the int8 per-row scale.
    ``n_actual``: real-city count of a padded instance (host int), or None.

    ``fused`` and ``pallas`` over a stack: ``key`` (B, 2),
    ``dist``/``tau``/``eta``/``choice_info`` (B, n, n), ``n_actual`` a (B,)
    int32 tensor or None (``n_host``: its host values, which bound the
    ``pallas`` step loop; read from the card when not given), ``active`` B
    host flags (None: all); tours (B, m, n) and lengths (B, m), an inactive
    instance's tours unspecified (``fused``: all zero).
    """
    if method not in METHODS:
        raise ValueError(f"unknown construction method {method}")
    if draw_mode not in sampling.DRAW_MODES:
        raise ValueError(f"unknown draw_mode {draw_mode!r}; "
                         f"supported: {', '.join(sampling.DRAW_MODES)}")
    if key.dim() == 2 and method not in ("fused", "pallas"):
        raise ValueError(f"construction {method!r} takes one instance; only "
                         "'fused' and 'pallas' take a stack")
    n = dist.shape[-1]
    ks = sampling.split(key)
    kp, kc = ks[..., 0, :], ks[..., 1, :].contiguous()
    start = place_ants(kp, m, n, n_actual)
    if method == "fused":
        assert tau is not None and eta is not None
        from ..kernels import ops as kops
        # A quantised tau arrives as its payload; only int8 has a scale.
        scale = tau_scale if tau.dtype == torch.int8 else None
        steps = kops.fused_walk(tau, eta, start, kc, float(alpha),
                                float(beta), n_actual, selection, draw_mode,
                                tau_scale=scale, active=active)
        return _finish(start, steps, dist, n_actual)
    extras = {"n_actual": n_actual, "active": active}
    if method == "pallas":
        step_impl = _make_pallas_step(selection, draw_mode)
    elif method == "task_baseline":
        assert tau is not None and eta is not None
        step_impl = _make_recompute_step(draw_mode)
        # the reference's exponents are traced float32 scalars
        extras.update(tau=tau, eta=eta, alpha=_scalar(alpha, dist),
                      beta=_scalar(beta, dist))
        choice_info = dist                # unread
    elif method in ("nn_list", "nn_list_eager"):
        assert nn is not None
        step_impl = _make_nn_step(selection, method == "nn_list", draw_mode)
        extras["nn"] = nn
    else:
        step_impl = _make_dense_step(
            "roulette" if method == "task_choice" and
            selection == "iroulette" else selection, draw_mode)
    one = key.dim() == 1
    if one:                              # one instance is a stack of one
        kc, start = kc[None], start[None]
        choice_info = choice_info[None]
        if n_actual is not None:
            n_host = (int(n_actual),)
    elif n_actual is not None and n_host is None:
        n_host = tuple(int(v) for v in n_actual.tolist())
    steps = _walk_steps(step_impl, kc, choice_info, start, n, extras,
                        None if n_actual is None else n_host)
    if one:
        start, steps = start[0], steps[0]
    return _finish(start, steps, dist, n_actual)


def _walk_steps(step_impl: StepImpl, kc: torch.Tensor,
                choice_info: torch.Tensor, start: torch.Tensor, n: int,
                extras: dict, n_host: Optional[Sequence[int]]
                ) -> torch.Tensor:
    """Steps 1..n-1 of every ant of a (B, m) stack -> (B, n-1, m) cities.
    Step ``t`` draws from ``fold_in(kc[b], t)``.  A padded instance emits
    its phantom tail in fixed index order once its real cities are
    exhausted (t >= its n_actual): a per-instance choice against the (B,)
    ``n_actual`` on the card, the selection's pick discarded as the
    reference discards it; a step past every instance's ``n_host`` launches
    no selection at all.  The draws of a real step never depend on another
    instance's count."""
    nb, m = start.shape
    dev = start.device
    bidx = torch.arange(nb, device=dev)[:, None]
    ants = torch.arange(m, device=dev)[None, :]
    visited = torch.zeros((nb, m, n), dtype=torch.bool, device=dev)
    visited[bidx, ants, start.long()] = True
    st = TourState(start, visited)
    hi = lo = n                         # t >= lo: some tail; t >= hi: all
    if n_host is not None:
        hi, lo = max(n_host), min(n_host)
        n_act = tsp.per_slot(extras["n_actual"], 2)
    # One batched hash gives every step's key: fold_in(kc, t), t = 1..n-1.
    step_keys = sampling.fold_in(kc, torch.arange(1, n, device=dev))
    steps = torch.empty((nb, n - 1, m), dtype=torch.int32, device=dev)
    for t in range(1, n):
        if t >= hi:
            nxt = torch.full((nb, m), t, dtype=torch.int32, device=dev)
        else:
            nxt = step_impl(step_keys[:, t - 1], choice_info, st, extras)
            if t >= lo:
                nxt = torch.where(t < n_act, nxt,
                                  torch.full_like(nxt, t))
        st.visited[bidx, ants, nxt.long()] = True   # in place: one buffer
        st = TourState(nxt, st.visited)
        steps[:, t - 1] = nxt
    return steps


def _scalar(value: Union[float, torch.Tensor],
            like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32)
    return floatops.const(value, like)


def choice_matrix(tau: torch.Tensor, eta: torch.Tensor,
                  alpha: Union[float, torch.Tensor],
                  beta: Union[float, torch.Tensor]) -> torch.Tensor:
    """The paper's Choice kernel on the pure route: tau^a * eta^b, with
    host-float integer exponents up to 4 folded into repeated products
    (the same folding as the ``choice_info`` kernel).  Tensor exponents
    (a ``Hyper``'s operands) take the generic ``x ** p``, as the
    reference's traced exponents do."""
    def pw(x, p):
        return x ** p if isinstance(p, torch.Tensor) else ipow(x, p)
    return pw(tau, alpha) * pw(eta, beta)
