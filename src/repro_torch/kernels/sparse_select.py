"""CUDA kernel: sparse candidate-page next-city selection for m ants.

Replaces ``repro/kernels/sparse_select.py::sparse_select``
(``_sparse_kernel``, ``pallas_call`` at sparse_select.py:159):
``sparse_select`` launches the float32 body (K7), ``sparse_select_quant``
the same kernel over an int8 or bfloat16 page payload, dequantised in
registers (the Pallas kernel's ``quant`` epilogue, sparse_select.py:79-85,
K6's sparse half).  Source: ``csrc/sparse_select.cu``.

Bound on the H100: bytes, and at the route's shapes (m = 64 ants, K = 20
page positions) a few hundred kilobytes at most, so the launch is the
cost.  Per (ant, position) the kernel reads the candidate id, tau and eta
and gathers the ant's tabu byte and draw at that city: one scattered
32-byte sector each.  The Pallas kernel gathers those two with one-hot
batched dots over city tiles; here one warp per ant reads them directly,
weights, masks and transforms in registers, and ends in one warp arg-max
with the lowest-index tie rule, beside the ``have`` bit.

``sparse_select_plain`` and ``sparse_select_quant_plain`` are the same
functions in plain PyTorch (the reference oracles ``ref.sparse_select``
and ``ref.sparse_select_quant``): the CPU path of ``ops.sparse_select``
and the yardsticks of the kernel on the card.

``sparse_walk`` launches the whole construction walk of the sparse kernel
route as one kernel (the reference's ``lax.scan`` over the steps): one
warp per ant runs every step -- page gather with the lazy overflow
distances, the threefry draw at the K candidates only (``draw_at_plain``
is its plain twin), the selection above, the page-fault fallback for an
ant whose page is exhausted, and the tabu update -- over a float32, int8
or bfloat16 page payload.  Bound: latency, S dependent steps of at least
two L2 round trips each; its bytes (pages, tabu rows, outputs) are about
2 MB at n = 2392, m = 64, K = 20.  With a leading instance axis (the
reference's ``pallas_call`` under ``vmap``, in the batched engine) one
launch walks a stack of B instances: B times the blocks, each instance's
``n_actual`` from a (B,) device array, an inactive instance skipped; the
single walk is its B = 1 case, one kernel body.  ``sparse_walk_plain`` is
the step loop on the host, every step through the plain versions, over a
stack a loop over its instances.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core import quant, sampling
from ..core.quant import dequantise_rows
from . import _build
from .choice_info import ipow
from .tour_select import mode_code, transform


def sparse_select_plain(tau_rows: torch.Tensor, eta_rows: torch.Tensor,
                        cand: torch.Tensor, visited: torch.Tensor,
                        rand: torch.Tensor, alpha: float = 1.0,
                        beta: float = 2.0, mode: str = "iroulette"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """tau_rows/eta_rows (m, K) page values; cand (m, K) city ids (< 0 =
    padding: visited 0, draw 0, the page's own tau and eta); visited and
    rand (m, n).  Returns (pos, have), both (m,) int32: the page position
    of the arg-max score, and 1 where an unvisited positive-weight
    candidate exists."""
    m = cand.shape[0]
    ants = torch.arange(m, device=cand.device)[:, None]
    real = cand >= 0
    safe = torch.where(real, cand, torch.zeros_like(cand)).long()
    zero = torch.zeros((), dtype=torch.float32, device=cand.device)
    gv = torch.where(real, visited[ants, safe].to(torch.float32), zero)
    gr = torch.where(real, rand[ants, safe], zero)
    w = ipow(tau_rows, alpha) * ipow(eta_rows, beta)
    mask = (gv == 0).to(w.dtype)
    v = transform(w, mask, gr, mode)
    pos = torch.argmax(v, dim=-1).to(torch.int32)
    have = ((w * mask).sum(-1) > 0).to(torch.int32)
    return pos, have


def sparse_select_quant_plain(tau_rows_q: torch.Tensor,
                              scale_rows: Optional[torch.Tensor],
                              eta_rows: torch.Tensor, cand: torch.Tensor,
                              visited: torch.Tensor, rand: torch.Tensor,
                              alpha: float = 1.0, beta: float = 2.0,
                              mode: str = "iroulette"
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantise the (m, K) page payload (``scale_rows`` already at page
    width), then ``sparse_select_plain``."""
    return sparse_select_plain(dequantise_rows(tau_rows_q, scale_rows),
                               eta_rows, cand, visited, rand, alpha, beta,
                               mode)


def _check(name, tau_rows, eta_rows, cand, visited, rand):
    m, k = cand.shape
    dev = cand.device
    _build.require(f"{name} cand", cand, torch.int32)
    _build.require(f"{name} tau", tau_rows, tau_rows.dtype, (m, k), dev)
    _build.require(f"{name} eta", eta_rows, torch.float32, (m, k), dev)
    _build.require(f"{name} visited", visited,
                   (torch.bool, torch.uint8, torch.int8), None, dev)
    if visited.shape[0] != m:
        raise ValueError(f"{name}: visited has {visited.shape[0]} rows, "
                         f"cand {m}")
    _build.require(f"{name} rand", rand, torch.float32, visited.shape, dev)


def sparse_select(tau_rows: torch.Tensor, eta_rows: torch.Tensor,
                  cand: torch.Tensor, visited: torch.Tensor,
                  rand: torch.Tensor, alpha: float = 1.0, beta: float = 2.0,
                  mode: str = "iroulette"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the float32 kernel on CUDA tensors; raises on anything else."""
    code = mode_code(mode)
    _build.require("sparse_select tau", tau_rows, torch.float32)
    _check("sparse_select", tau_rows, eta_rows, cand, visited, rand)
    m, k = cand.shape
    pos = torch.empty(m, dtype=torch.int32, device=cand.device)
    have = torch.empty_like(pos)
    _build.launch("sparse_select", cand.device, tau_rows.data_ptr(),
                  eta_rows.data_ptr(), cand.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), pos.data_ptr(), have.data_ptr(), m, k,
                  visited.shape[1], float(alpha), float(beta), code)
    _build.count(sparse_select)
    return pos, have


sparse_select.launches = 0


def sparse_select_quant(tau_rows_q: torch.Tensor,
                        scale_rows: Optional[torch.Tensor],
                        eta_rows: torch.Tensor, cand: torch.Tensor,
                        visited: torch.Tensor, rand: torch.Tensor,
                        alpha: float = 1.0, beta: float = 2.0,
                        mode: str = "iroulette"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel over an int8 (with its (m, K) float32
    ``scale_rows``) or bfloat16 page payload on CUDA tensors; raises on
    anything else."""
    code = mode_code(mode)
    _build.require("sparse_select_quant tau", tau_rows_q,
                   (torch.int8, torch.bfloat16))
    _check("sparse_select_quant", tau_rows_q, eta_rows, cand, visited, rand)
    m, k = cand.shape
    scale_ptr = None
    if tau_rows_q.dtype == torch.int8:
        if scale_rows is None:
            raise ValueError("sparse_select_quant: an int8 payload needs its "
                             "scales")
        _build.require("sparse_select_quant scale", scale_rows,
                       torch.float32, (m, k), cand.device)
        scale_ptr = scale_rows.data_ptr()
    pos = torch.empty(m, dtype=torch.int32, device=cand.device)
    have = torch.empty_like(pos)
    _build.launch("sparse_select_quant", cand.device, tau_rows_q.data_ptr(),
                  1 if tau_rows_q.dtype == torch.int8 else 2, scale_ptr,
                  eta_rows.data_ptr(), cand.data_ptr(), visited.data_ptr(),
                  rand.data_ptr(), pos.data_ptr(), have.data_ptr(), m, k,
                  visited.shape[1], float(alpha), float(beta), code)
    _build.count(sparse_select_quant)
    return pos, have


sparse_select_quant.launches = 0


# sparse/store._round_ewt's rounding rules and the draw modes, as the walk
# kernel numbers them; the kernel route draws U(1e-6, 1).
EWT_CODES = {"EUC_2D": 0, "CEIL_2D": 1, "ATT": 2, "RAW": 3}
DRAW_CODES = {"packed": 0, "counter": 1}
DRAW_MIN, DRAW_MAX = 1e-6, 1.0


def draw_at_plain(key: torch.Tensor, ants: torch.Tensor,
                  cities: torch.Tensor, n: int,
                  draw_mode: str = "packed") -> torch.Tensor:
    """The walk kernel's pointwise draw in plain PyTorch: element
    [ants, cities] of the step's (m, n) U(1e-6, 1) draw
    (``sampling.uniform`` packed, ``counter_uniform`` counter), hashed at
    those pairs only; 0 where a city id is < 0."""
    a = ants.to(torch.int64)
    c = cities.to(torch.int64)
    safe = torch.where(c >= 0, c, torch.zeros_like(c))
    mask = 0xFFFFFFFF
    if draw_mode == "counter":
        ctr = (a * sampling.COUNTER_STRIDE + safe) & mask
        bits, _ = sampling.threefry2x32(key[0], key[1], ctr,
                                        torch.zeros_like(ctr))
    else:
        flat = a * n + safe
        y0, y1 = sampling.threefry2x32(key[0], key[1], flat >> 32,
                                       flat & mask)
        bits = y0 ^ y1
    u = sampling._uniform_from_bits(
        bits, DRAW_MIN, sampling.uniform_span(draw_mode, DRAW_MIN, DRAW_MAX))
    return torch.where(c >= 0, u, torch.zeros_like(u))


def _payload(tau) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(payload, int8 per-row scale or None) of a page store."""
    if isinstance(tau, quant.QuantTau):
        return tau.q, (tau.scale if tau.q.dtype == torch.int8 else None)
    return tau, None


def sparse_walk_plain(problem, tau, ovf_city: torch.Tensor, ovf_tau,
                      start: torch.Tensor, visited: torch.Tensor,
                      keys: torch.Tensor, selection: str = "iroulette",
                      alpha: float = 1.0, beta: float = 2.0,
                      ewt: str = "RAW", draw_mode: str = "packed",
                      n_actual=None, active: Optional[Sequence[bool]] = None):
    """The kernel route's walk as a host loop of plain PyTorch steps (the
    full-width draw, ``sparse_select_plain``, the fallback's (m, n) lazy
    rows) on any device.  Same arguments and results as ``sparse_walk``; a
    stack is a loop of single walks over its active instances."""
    from ..sparse import construct
    return construct.host_walks(problem, tau, ovf_city, ovf_tau, start,
                                visited, keys, selection, alpha, beta, ewt,
                                True, draw_mode, n_actual, active)


def sparse_walk(problem, tau, ovf_city: torch.Tensor, ovf_tau,
                start: torch.Tensor, visited: torch.Tensor,
                keys: torch.Tensor, selection: str = "iroulette",
                alpha: float = 1.0, beta: float = 2.0, ewt: str = "RAW",
                draw_mode: str = "packed", n_actual=None,
                active: Optional[Sequence[bool]] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the walk kernel on CUDA tensors; raises on anything else.

    ``problem`` is a ``SparseProblem`` (coords, cand, cand_dist,
    cand_eta); ``tau`` (n, k) and ``ovf_tau`` (n, O) are float32 pages or
    ``QuantTau`` stores of one payload type; ``start`` (m,) int32 the
    cities the ants stand on; ``visited`` (m, n) bool, updated in place;
    ``keys`` (S, 2) int64, one threefry key per step (S <= n - 1).  With
    ``n_actual``, steps t = s + 1 >= n_actual emit city t at length 0 and
    the fallback scans real cities only.  Returns (cities (S, m) int32, edge lengths
    (S, m) float32, fallback steps per ant (m,) int32).

    The instance axis: every operand with a leading B (coords (B, n, 2),
    pages (B, n, k), overflow (B, n, O), int8 row scales (B, n, 1), start
    (B, m), visited (B, m, n), keys (B, S, 2)) walks B instances in one
    launch; ``n_actual`` a host int (the kernel reads it from a cached
    (B,) copy on the card) or a (B,) int32 tensor on the card whose
    values the caller has checked to lie in [1, n], ``active`` B
    host flags (None: all).  Each instance is bitwise its own single
    launch; an inactive one costs no walk, its results are zero and its
    tabu rows untouched.  ``launches`` counts launches, ``slot_launches``
    the instances they walked."""
    code = mode_code(selection)
    if draw_mode not in DRAW_CODES:
        raise ValueError(f"sparse_walk: unknown draw_mode {draw_mode!r}")
    if ewt not in EWT_CODES:
        raise ValueError(f"sparse_walk: unsupported edge_weight_type {ewt}")
    coords, cand, cand_dist, cand_eta = problem[:4]
    lead = tuple(cand.shape[:-2])
    if len(lead) > 1:
        raise ValueError("sparse_walk: cand must be (n, k) or (B, n, k)")
    nb = lead[0] if lead else 1
    n, k = cand.shape[-2:]
    dev = cand.device
    _build.require("sparse_walk cand", cand, torch.int32)
    _build.require("sparse_walk coords", coords, torch.float32,
                   lead + (n, 2), dev)
    if coords.data_ptr() % 8:
        raise ValueError("sparse_walk: coords is not 8-byte aligned")
    for name, t in (("cand_dist", cand_dist), ("cand_eta", cand_eta)):
        _build.require(f"sparse_walk {name}", t, torch.float32,
                       lead + (n, k), dev)
    o = ovf_city.shape[-1]
    _build.require("sparse_walk ovf_city", ovf_city, torch.int32,
                   lead + (n, o), dev)
    q, scale = _payload(tau)
    oq, oscale = _payload(ovf_tau)
    dtypes = (torch.float32, torch.int8, torch.bfloat16)
    _build.require("sparse_walk tau", q, dtypes, lead + (n, k), dev)
    _build.require("sparse_walk ovf_tau", oq, q.dtype, lead + (n, o), dev)
    payload = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}[q.dtype]
    scale_ptr = oscale_ptr = None
    if payload == 1:
        _build.require("sparse_walk tau scale", scale, torch.float32,
                       lead + (n, 1), dev)
        scale_ptr = scale.data_ptr()
        if o:
            _build.require("sparse_walk ovf_tau scale", oscale,
                           torch.float32, lead + (n, 1), dev)
            oscale_ptr = oscale.data_ptr()
    m = start.shape[-1]
    _build.require("sparse_walk start", start, torch.int32, lead + (m,), dev)
    _build.require("sparse_walk visited", visited, torch.bool,
                   lead + (m, n), dev)
    steps = keys.shape[-2]
    _build.require("sparse_walk keys", keys, torch.int64,
                   lead + (steps, 2), dev)
    if steps > n - 1:
        raise ValueError(f"sparse_walk: {steps} steps over {n} cities")
    if n_actual is not None and not isinstance(n_actual, torch.Tensor):
        if not 1 <= int(n_actual) <= n:
            raise ValueError(f"sparse_walk: n_actual {n_actual} not in "
                             f"[1, {n}]")
        n_actual = _build.count_array(n_actual, nb, dev)
    n_act_ptr = None
    if n_actual is not None:
        # read on the card only: the caller has checked a tensor's values
        # (sparse_colony_step_batch does)
        _build.require("sparse_walk n_actual", n_actual, torch.int32, (nb,),
                       dev)
        n_act_ptr = n_actual.data_ptr()
    flags, walked = _build.active_flags(active, nb, dev)
    alloc = torch.empty if flags is None else torch.zeros
    out_city = alloc(lead + (steps, m), dtype=torch.int32, device=dev)
    out_dist = alloc(lead + (steps, m), dtype=torch.float32, device=dev)
    fallbacks = alloc(lead + (m,), dtype=torch.int32, device=dev)
    span = sampling.uniform_span(draw_mode, DRAW_MIN, DRAW_MAX)
    _build.launch("sparse_walk", dev, coords.data_ptr(), cand.data_ptr(),
                  cand_dist.data_ptr(), cand_eta.data_ptr(), q.data_ptr(),
                  payload, scale_ptr, ovf_city.data_ptr(), oq.data_ptr(),
                  oscale_ptr, start.data_ptr(), visited.data_ptr(),
                  keys.data_ptr(), out_city.data_ptr(), out_dist.data_ptr(),
                  fallbacks.data_ptr(), nb, m, n, k, o, steps, n_act_ptr,
                  None if flags is None else flags.data_ptr(),
                  code, DRAW_CODES[draw_mode], EWT_CODES[ewt], DRAW_MIN,
                  span, float(alpha), float(beta))
    _build.count(sparse_walk, walked)
    return out_city, out_dist, fallbacks


sparse_walk.launches = 0
sparse_walk.slot_launches = 0


def page_operands(n: int, m: int, k: int, tau_dtype: str,
                  device: torch.device, seed: int = 0):
    """One construction step's K7 operands, for checking and timing the
    kernel: m ants over pages of K = k + 4 positions, gathered by the
    route's own ``_candidate_page`` from ``random_instance(n, seed=n)``: k
    candidates, then 4 overflow columns of random adopted cities (empty
    slots map to the ant's own city).  Ants 0-3 have their whole page
    visited (have = 0); ant 4 has ids < 0 at every third position.
    Returns (tau_rows, scale or None, eta_rows, cities, visited, rand)."""
    from ..core import quant, tsp
    from ..sparse import construct, store
    gen = torch.Generator(device=device).manual_seed(seed)
    prob = store.make_sparse_problem(tsp.random_instance(n, seed=n), k,
                                     device=device)
    cur = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    ovf_city = torch.randint(-1, n, (n, 4), generator=gen, device=device,
                             dtype=torch.int32)
    tau = torch.rand((n, k), generator=gen, device=device) * 1e-3 + 1e-4
    ovf_tau = torch.rand((n, 4), generator=gen, device=device) * 1e-3
    if tau_dtype != "fp32":
        key = torch.tensor([0, n], device=device)
        tau = quant.quantise(tau, tau_dtype, key=key)
        ovf_tau = quant.quantise(ovf_tau, tau_dtype, key=key)
    cities, tau_row, scale, eta_row, _ = construct._candidate_page(
        prob, tau, ovf_city, ovf_tau, cur, "RAW")
    visited = torch.rand((m, n), generator=gen, device=device) < 0.5
    visited[torch.arange(m, device=device), cur.long()] = True
    visited[:4].scatter_(1, cities[:4].long(), True)
    cities[4, ::3] = -1
    rand = (torch.rand((m, n), generator=gen, device=device) * (1 - 1e-6)
            + 1e-6)
    return tau_row, scale, eta_row, cities, visited, rand


def walk_operands(n: int, m: int, k: int, o: int, tau_dtype: str,
                  device: torch.device, seed: int = 0,
                  n_pad: Optional[int] = None,
                  window: Optional[int] = None, ewt: str = "EUC_2D"):
    """One walk's operands, for checking and timing ``sparse_walk``: the
    problem of ``random_instance(n, seed=n)`` (``ewt`` rounding, padded to
    ``n_pad``), random pages and O overflow slots of random cities (-1 =
    empty) in ``tau_dtype``, and m ants.  Data-parallel: each ant stands on
    a random real city, S = n - 1 steps (n_pad - 1 padded).  With
    ``window`` (Partial-ACO): every city but a random window of that many is
    visited, the ant stands on a visited one, S = window.  Returns
    (problem, tau, ovf_city, ovf_tau, start, visited, keys)."""
    from ..core import tsp
    from ..sparse import store
    gen = torch.Generator(device=device).manual_seed(seed)
    inst = dataclasses.replace(tsp.random_instance(n, seed=n),
                               edge_weight_type=ewt)
    problem = store.make_sparse_problem(inst, k, n_pad, device=device)
    nn = problem.n
    tau = torch.rand((nn, k), generator=gen, device=device) * 1e-3 + 1e-4
    ovf_tau = torch.rand((nn, o), generator=gen, device=device) * 1e-3
    ovf_city = torch.randint(-1, n, (nn, o), generator=gen, device=device,
                             dtype=torch.int32)
    if tau_dtype != "fp32":
        key = torch.tensor([0, seed], device=device)
        tau = quant.quantise(tau, tau_dtype, key=key)
        ovf_tau = quant.quantise(ovf_tau, tau_dtype, key=key)
    ants = torch.arange(m, device=device)
    if window:
        perm = torch.stack([torch.randperm(n, generator=gen, device=device)
                            for _ in range(m)])
        visited = torch.ones((m, nn), dtype=torch.bool, device=device)
        visited[ants[:, None], perm[:, :window]] = False
        start = perm[:, window].to(torch.int32).contiguous()
        steps = window
    else:
        start = torch.randint(0, n, (m,), generator=gen, device=device,
                              dtype=torch.int32)
        visited = torch.zeros((m, nn), dtype=torch.bool, device=device)
        visited[ants, start.long()] = True
        steps = nn - 1
    keys = sampling.fold_in(sampling.prng_key(seed + 1, device),
                            torch.arange(1, steps + 1, device=device))
    return problem, tau, ovf_city, ovf_tau, start, visited, keys


def stack_walk_operands(ns, n_pad: int, m: int, k: int, o: int,
                        tau_dtype: str, device: torch.device, seed: int = 0,
                        window: Optional[int] = None, ewt: str = "EUC_2D"):
    """A stack of ``walk_operands`` in one bucket of ``n_pad`` cities, one
    instance per size in ``ns`` (instance b from seed ``seed + b``), for
    checking and timing the walk's instance axis.  Every operand gains a
    leading B; the problem carries the sizes as its host ``n_actual``
    tuple, as a bucket's does.  Returns (problem, tau, ovf_city, ovf_tau,
    start, visited, keys)."""
    from .. import tree
    from ..sparse import store
    slots = [walk_operands(n, m, k, o, tau_dtype, device, seed + b, n_pad,
                           window, ewt) for b, n in enumerate(ns)]
    problem = store.SparseProblem(
        *(torch.stack([s[0][i] for s in slots]) for i in range(4)),
        n_actual=tuple(int(n) for n in ns))
    return (problem,) + tuple(tree.stack([s[i] for s in slots])
                              for i in range(1, 7))
