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
"""
from __future__ import annotations

from typing import Optional

import torch

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
    sparse_select.launches += 1
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
    sparse_select_quant.launches += 1
    return pos, have


sparse_select_quant.launches = 0


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
