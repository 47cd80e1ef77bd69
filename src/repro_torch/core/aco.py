"""The ACO engine: Ant System (paper's subject) plus MMAS / ACS variants.

The PyTorch port of ``repro.core.aco``: the same ``ACOConfig`` fields, the
same ``ColonyState``/``Problem`` containers as ``NamedTuple``s of tensors,
and the same iteration, step for step and draw for draw.  One colony
iteration (``colony_step``) constructs m tours, updates the pheromone and
tracks the best tour.

With ``use_pallas=True`` (the kernel route) construction and update run
through the CUDA kernels of ``kernels/``: ``construction="data_parallel"``
becomes one ``fused_walk`` kernel launch, every step of every ant (no
(n, n) choice matrix, no (m, n) draw tensor), other constructions take
the ``choice_info`` kernel, and the update is the fused
``pheromone_update`` kernel.  Local search (``local_search``) reduces its
2-opt moves with the ``two_opt_best`` kernel.  A quantised pheromone store
(``tau_dtype`` bf16/int8, ``core/quant.py``) reaches the fused walk as its
payload, dequantised inside the kernel.  The paper's slower ladder
constructions (``task_choice``, ``nn_list``, ``nn_list_eager``) read their
choice matrix from one ``choice_info`` launch on the kernel route;
``task_baseline`` recomputes its rows and reads none.  On CPU tensors the
kernels' plain versions run instead (``kernels/ops.py``).

Entry points (``make_problem``, ``init_colony``, ``run``, ``Hyper.make``)
take a ``device`` and run on CUDA when none is given
(``repro_torch.device.resolve``).  ``sparse=True`` runs the O(n·k) paged
route of ``repro_torch.sparse``.  ``metrics=True`` makes ``colony_step``
return an ``obs.StepMetrics`` as well, read from intermediates the step
computes anyway, so the state is bitwise the same either way.  A
``Problem.hyper`` (per-instance alpha/beta/rho/q as float32 scalar
tensors) overrides the config's fields on the pure route.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import tree
from . import floatops, localsearch, pheromone, quant, sampling, strategies
from . import tsp


@dataclasses.dataclass(frozen=True)
class ACOConfig:
    # Field for field the reference's ACOConfig, so that both packages'
    # configs are built from the same keyword arguments.
    alpha: float = 1.0
    beta: float = 2.0
    rho: float = 0.5
    q: float = 1.0                 # deposit numerator (1/C^k scaled by q)
    m: Optional[int] = None        # ants; None => m = n (paper §V)
    variant: str = "as"            # as | mmas | acs
    construction: str = "data_parallel"
    selection: str = "iroulette"   # iroulette (paper) | gumbel | roulette | greedy
    draw_mode: str = "packed"      # packed | counter (sampling.py)
    nn_k: int = 30                 # NN-list length (paper uses 30)
    deposit: str = "scatter"       # pheromone strategy (see pheromone.py)
    deposit_tile: int = 64
    iterations: int = 100
    seed: int = 0
    use_pallas: bool = False       # the kernel route (kernels/)
    local_search: str = "none"
    ls_every: int = 1
    ls_tours: str = "all"
    ls_rounds: int = 24
    ls_improvement: str = "best"
    ls_seg_max: int = 3
    mmas_best: str = "iteration"   # iteration | global
    q0: float = 0.9
    xi: float = 0.1
    sparse: bool = False
    sparse_k: int = 32
    sparse_overflow: int = 4
    partial_window: int = 64
    tau_dtype: str = "fp32"
    tau_round: str = "stochastic"
    tau_compensation: bool = False
    metrics: bool = False

    def num_ants(self, n: int) -> int:
        return self.m if self.m is not None else n


class ColonyState(NamedTuple):
    tau: Union[torch.Tensor, quant.QuantTau]  # (n, n) f32, or QuantTau
    best_tour: torch.Tensor  # (n,) int32
    best_len: torch.Tensor   # () float32
    iteration: torch.Tensor  # () int32
    key: torch.Tensor        # (2,) int64 threefry key (two uint32 words)


class Hyper(NamedTuple):
    """Per-instance ACO hyperparameters as float32 scalar tensors.

    Attached to ``Problem.hyper`` they override the ``ACOConfig`` fields
    of the same name inside ``colony_step``, so one batch
    (``solver.engine``) can mix tuning profiles across slots.  The
    exponents then take the generic ``x ** p`` of
    ``strategies.choice_matrix`` instead of the integer folding, and
    ``1 - rho``, ``rho * q`` and the MMAS bounds are computed in float32
    at run time, as the reference's traced operands are: numbers compare
    only within one operand mode, so batched == solo holds bitwise when
    both carry a Hyper.  The kernel route rejects a Hyper.
    """
    alpha: torch.Tensor      # () float32 choice exponent on tau
    beta: torch.Tensor       # () float32 choice exponent on eta
    rho: torch.Tensor        # () float32 evaporation rate
    q: torch.Tensor          # () float32 deposit numerator

    @classmethod
    def make(cls, cfg: "ACOConfig", alpha: Optional[float] = None,
             beta: Optional[float] = None, rho: Optional[float] = None,
             q: Optional[float] = None,
             device: _device.DeviceLike = None) -> "Hyper":
        """Profile from a config plus any per-field overrides."""
        dev = _device.resolve(device)

        def pick(v, d):
            return torch.tensor(np.float32(d if v is None else v),
                                device=dev)
        return cls(pick(alpha, cfg.alpha), pick(beta, cfg.beta),
                   pick(rho, cfg.rho), pick(q, cfg.q))


class Problem(NamedTuple):
    """Device-resident constants for one TSP instance.

    ``n_actual`` is None for ordinary instances; for a padded instance
    (``tsp.pad_instance``: phantom cities at inf distance, eta exactly 0)
    it is the host int count of real cities and makes colony_step
    mask-aware.  ``hyper`` is None, or a ``Hyper`` whose operands take
    precedence over the config's alpha/beta/rho/q.
    """
    dist: torch.Tensor       # (n, n) float32
    eta: torch.Tensor        # (n, n) float32 (1/d)
    nn: torch.Tensor         # (n, k) int32
    n_actual: Optional[int] = None
    hyper: Optional[Hyper] = None


def make_problem(instance: tsp.TSPInstance, nn_k: int = 30,
                 device: _device.DeviceLike = None) -> Problem:
    dev = _device.resolve(device)
    dist = torch.from_numpy(instance.distances()).to(dev)
    eta = tsp.heuristic_matrix(dist)
    nn = tsp.nn_lists(dist, min(nn_k, instance.n - 1))
    return Problem(dist, eta, nn)


def initial_tau(instance: tsp.TSPInstance, cfg: ACOConfig,
                rho: Optional[float] = None) -> float:
    """tau0 = m / C_nn (AS), 1/(rho C_nn) (MMAS), 1/(n C_nn) (ACS)."""
    d = instance.distances()
    _, c_nn = tsp.nearest_neighbour_tour(d)
    n = instance.n
    m = cfg.num_ants(n)
    if cfg.variant == "mmas":
        return 1.0 / ((cfg.rho if rho is None else rho) * c_nn)
    if cfg.variant == "acs":
        return 1.0 / (n * c_nn)
    return m / c_nn


def make_tau(tau_f32: torch.Tensor, cfg: ACOConfig
             ) -> Union[torch.Tensor, quant.QuantTau]:
    """Initial tau in the config's resident representation: raw fp32, or a
    QuantTau rounded to nearest."""
    if not quant.is_quantised(cfg.tau_dtype):
        return tau_f32
    quant.validate_tau_dtype(cfg.tau_dtype, cfg.tau_round)
    return quant.quantise(tau_f32, cfg.tau_dtype,
                          compensation=cfg.tau_compensation)


def init_colony(instance: tsp.TSPInstance, cfg: ACOConfig,
                seed: Optional[int] = None,
                device: _device.DeviceLike = None) -> ColonyState:
    dev = _device.resolve(device)
    n = instance.n
    tau0 = np.float32(initial_tau(instance, cfg))
    return ColonyState(
        tau=make_tau(torch.full((n, n), float(tau0), dtype=torch.float32,
                                device=dev), cfg),
        best_tour=torch.arange(n, dtype=torch.int32, device=dev),
        best_len=torch.tensor(np.float32(np.inf), device=dev),
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        key=sampling.prng_key(cfg.seed if seed is None else seed, dev),
    )


def _check_supported(problem: Problem, cfg: ACOConfig) -> None:
    """The kernel route's and the quantised store's rejections, with the
    reference's messages (a Hyper on either raises)."""
    from ..kernels import ops as kops
    if cfg.use_pallas or cfg.tau_dtype != "fp32":
        kops.check_kernel_route(masked=problem.n_actual is not None,
                                hyper=problem.hyper is not None,
                                tau_dtype=cfg.tau_dtype)


Scalar = Union[float, torch.Tensor]


def operand(value: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A Hyper operand as it is; a config float as a float32 scalar on
    ``like``'s device (``floatops.const``)."""
    if isinstance(value, torch.Tensor):
        return value
    return floatops.const(value, like)


def ls_config(cfg: ACOConfig) -> localsearch.LocalSearchConfig:
    """The LocalSearchConfig embedded in an ACOConfig."""
    return localsearch.LocalSearchConfig(
        kind=cfg.local_search, rounds=cfg.ls_rounds,
        improvement=cfg.ls_improvement, seg_max=cfg.ls_seg_max,
        use_pallas=cfg.use_pallas)


def polish_tours(problem: Problem, tours: torch.Tensor, cfg: ACOConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local-search-improve (m, n) tours -> (tours, lengths); mask-aware
    when problem.n_actual is set."""
    return localsearch.improve_with_lengths(
        problem.dist, problem.nn, tours, ls_config(cfg), problem.n_actual)


def _apply_local_search(problem: Problem, res: strategies.TourResult,
                        iterations: Sequence[int], cfg: ACOConfig,
                        active: Optional[Sequence[bool]],
                        n_act: Optional[torch.Tensor]
                        ) -> strategies.TourResult:
    """Polish a stack's constructed tours per ``cfg.ls_tours``: each slot
    that is active and at an iteration the ``cfg.ls_every`` gate admits
    (the reference's ``lax.cond``, a host choice per slot here from the
    host ``iterations``), the others' tours as they were.  The polished
    slots run as one stack, or in groups where the card's free memory
    holds fewer (``localsearch.slots_per_pass``); rows are independent, so
    every grouping gives the same tours."""
    if cfg.ls_tours not in ("all", "iteration_best"):
        raise ValueError(f"unknown ls_tours {cfg.ls_tours!r}")
    n_slots, m, n = res.tours.shape
    slots = [b for b in range(n_slots)
             if (active is None or active[b])
             and (cfg.ls_every <= 1 or iterations[b] % cfg.ls_every == 0)]
    if not slots:
        return res
    tours, lengths = res.tours, res.lengths
    if cfg.ls_tours == "iteration_best":
        # each slot's own best ant, a (B, 1, n) stack
        ib = torch.argmin(lengths, dim=-1)[:, None]
        tours = tours.gather(1, ib[..., None].expand(n_slots, 1, n))
        lengths = lengths.gather(1, ib)
    per = localsearch.slots_per_pass(tours.device, len(slots),
                                     tours.shape[1], n, problem.nn.shape[-1])
    ls_cfg = ls_config(cfg)
    if per == len(slots) == n_slots:
        out_t, out_l = localsearch.improve_with_lengths(
            problem.dist, problem.nn, tours, ls_cfg, n_act)
    else:
        out_t, out_l = tours.clone(), lengths.clone()
        for g in range(0, len(slots), per):
            idx = torch.tensor(slots[g:g + per], dtype=torch.long,
                               device=tours.device)
            pol, pol_len = localsearch.improve_with_lengths(
                problem.dist[idx], problem.nn[idx], tours[idx], ls_cfg,
                None if n_act is None else n_act[idx])
            out_t.index_copy_(0, idx, pol)
            out_l.index_copy_(0, idx, pol_len)
    if cfg.ls_tours == "iteration_best":
        out_t = res.tours.scatter(1, ib[..., None].expand(n_slots, 1, n),
                                  out_t)
        out_l = res.lengths.scatter(1, ib, out_l)
    return strategies.TourResult(out_t, out_l)


def mmas_bounds(best_len: torch.Tensor, cfg: ACOConfig, n: int,
                n_actual: Union[int, torch.Tensor, None],
                q: Optional[Scalar] = None, rho: Optional[Scalar] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """MMAS trail limits: tau_max = q / (rho * best_len), tau_min =
    tau_max / (2 n), in the numbers of the reference's jitted step: XLA
    turns the division by the compile-time constant 2n into a
    multiplication by its float32 reciprocal.  A padded instance's
    n_actual is a traced value there, and XLA rewrites
    (q / (rho * len)) / (2 n) as q / (rho * (len * 2 n)).  ``q``/``rho``
    override the config's (a Hyper's operands).  A batched step's (B,)
    ``best_len`` takes a (B,) ``n_actual`` tensor (2 n is exact in
    float32), each bound bitwise its instance's own."""
    q = operand(cfg.q if q is None else q, best_len)
    rho = operand(cfg.rho if rho is None else rho, best_len)
    tau_max = q / (rho * best_len)
    if n_actual is None:
        recip = np.float32(1.0) / np.float32(2.0 * n)
        return tau_max * floatops.const(recip, best_len), tau_max
    if isinstance(n_actual, torch.Tensor):
        two_n = (2 * n_actual).to(torch.float32)
    else:
        two_n = floatops.const(2.0 * n_actual, best_len)
    return q / (rho * (best_len * two_n)), tau_max


def batched_route(cfg: ACOConfig, problem: Problem) -> bool:
    """Whether ``colony_step_batch`` steps a stack of this problem in one
    pass: the dense kernel routes (``use_pallas``, the fused or the
    ``pallas`` construction, with or without local search) without Hyper.
    The pure routes take one instance at a time."""
    return (cfg.use_pallas
            and cfg.construction in ("data_parallel", "pallas")
            and problem.hyper is None
            and cfg.variant in ("as", "mmas", "acs"))


def slot_n_actual(problem: Problem, device) -> Optional[torch.Tensor]:
    """A stacked problem's host ``n_actual`` tuple as a (B,) int32 tensor
    on ``device`` (None for an unpadded problem): a fill when every slot
    shares one value, else one copy."""
    na = problem.n_actual
    if na is None:
        return None
    if len(set(na)) == 1:
        return torch.full((len(na),), na[0], dtype=torch.int32,
                          device=device)
    return torch.tensor(na, dtype=torch.int32, device=device)


def _slot(problem: Problem, b: int) -> Problem:
    """Instance ``b`` of a stacked problem (views, host ``n_actual``)."""
    return Problem(problem.dist[b], problem.eta[b], problem.nn[b],
                   None if problem.n_actual is None else problem.n_actual[b],
                   None if problem.hyper is None else
                   Hyper(*(x[b] for x in problem.hyper)))


def colony_step_batch(problem: Problem, states: ColonyState,
                      cfg: ACOConfig,
                      active: Optional[Sequence[bool]] = None,
                      n_actual: Optional[torch.Tensor] = None,
                      iterations: Optional[Sequence[int]] = None) -> tuple:
    """One full ACO iteration of B colonies stacked on a leading axis:
    construct m tours each, update pheromone, track best.

    ``problem`` is stacked: (B, ...) tensors, ``n_actual`` a host tuple of
    B ints (or None, unpadded), ``hyper`` (B,) operands (or None);
    ``states`` is a stacked ColonyState.  Returns (new_states,
    iteration_best_lengths (B,)); with ``cfg.metrics`` also the (B,)-stacked
    ``obs.StepMetrics``.  Row b of every result is bitwise what the step of
    instance b alone gives: this is the one implementation of the step, and
    ``colony_step`` is its B = 1 case.

    On ``batched_route`` the stack takes, per iteration, one ``fused_walk``
    launch (or, on ``construction="pallas"``, one ``choice_info`` launch
    and one ``tour_select`` launch a step), a local-search pass over the
    stack (one ``two_opt_best`` launch a round), one ``pheromone_update``
    launch and plain tensor work over (B, ...); the pure routes take B = 1
    only.  ``active``: B host flags (None: all); the kernels skip an
    inactive instance, and its rows of the result are unspecified: the
    caller keeps its old state (the reference's where-freeze).
    ``n_actual``: the problem's per-slot counts as a (B,) int32 tensor on
    the states' device (``slot_n_actual``), built here when not given.
    ``iterations``: the slots' iteration counts on the host, for the
    ``ls_every`` gate (read from ``states`` when not given and needed).
    """
    _check_supported(problem, cfg)
    n_slots = states.key.shape[0]
    n = problem.dist.shape[-1]
    m = cfg.num_ants(n)
    dev = states.key.device
    stacked = batched_route(cfg, problem)
    if n_slots != 1 and not stacked:
        raise ValueError("colony_step_batch steps a stack only on the dense "
                         "kernel routes without Hyper; step other routes "
                         "one instance at a time")
    # the launchers cannot read a device n_actual: its host values are
    # checked here, once for the whole stack
    if problem.n_actual is not None and not all(
            1 <= v <= n for v in problem.n_actual):
        raise ValueError(f"colony_step_batch: n_actual {problem.n_actual} "
                         f"not all in [1, {n}]")
    n_act = n_actual if n_actual is not None or problem.n_actual is None \
        else slot_n_actual(problem, dev)
    h = problem.hyper
    alpha = cfg.alpha if h is None else h.alpha
    beta = cfg.beta if h is None else h.beta
    rho = cfg.rho if h is None else h.rho
    q = cfg.q if h is None else h.q
    quantised = quant.is_quantised(cfg.tau_dtype)
    # The extra key feeds quantise-on-store; the fp32 split is unchanged,
    # so its key trajectory is too.
    ks = sampling.split(states.key, 3 if quantised else 2)   # (B, k, 2)
    key, k_tour = ks[:, 0], ks[:, 1]
    # Transient fp32 view for this step's compute.
    tau_full = quant.dequantise(states.tau)

    if stacked and cfg.construction == "data_parallel":
        # The fused_walk kernel does the whole construction: no (n, n)
        # choice precompute on this route at all; a quantised store
        # reaches it as its payload, dequantised inside the kernel.
        tau_c, tau_scale = tau_full, None
        if quantised:
            tau_c = states.tau.q
            tau_scale = states.tau.scale if cfg.tau_dtype == "int8" \
                else None
        res = strategies.construct_tours(
            k_tour, problem.dist, None, m, method="fused",
            selection=cfg.selection, tau=tau_c, eta=problem.eta,
            alpha=alpha, beta=beta, n_actual=n_act,
            draw_mode=cfg.draw_mode, tau_scale=tau_scale, active=active)
    elif stacked:
        # the paper's unfused pair over the stack: one choice_info launch,
        # then one tour_select launch a step
        from ..kernels import ops as kops
        choice = kops.choice_info(tau_full, problem.eta, alpha, beta, n_act,
                                  active)
        res = strategies.construct_tours(
            k_tour, problem.dist, choice, m, method="pallas",
            selection=cfg.selection, n_actual=n_act,
            draw_mode=cfg.draw_mode, active=active, n_host=problem.n_actual)
    else:
        # a pure route: the one instance of a stack of one
        p0 = _slot(problem, 0)
        h0 = p0.hyper
        a0 = cfg.alpha if h0 is None else h0.alpha
        b0 = cfg.beta if h0 is None else h0.beta
        choice = None                     # task_baseline recomputes rows
        if cfg.construction in strategies.READS_CHOICE and cfg.use_pallas:
            # the reference's _choice: one choice_info launch over the slot
            from ..kernels import ops as kops
            choice = kops.choice_info(tau_full, problem.eta, alpha, beta,
                                      n_act)[0]
        elif cfg.construction in strategies.READS_CHOICE:
            choice = strategies.choice_matrix(tau_full[0], p0.eta, a0, b0)
        r = strategies.construct_tours(
            k_tour[0], p0.dist, choice, m, method=cfg.construction,
            selection=cfg.selection, nn=p0.nn, tau=tau_full[0], eta=p0.eta,
            alpha=a0, beta=b0, n_actual=p0.n_actual, draw_mode=cfg.draw_mode)
        res = strategies.TourResult(r.tours[None], r.lengths[None])

    pre_ls_lengths = None
    if cfg.local_search != "none":
        # improved tours drive best-tracking and the deposit
        pre_ls_lengths = res.lengths
        if iterations is None and cfg.ls_every > 1:
            iterations = states.iteration.tolist()
        res = _apply_local_search(problem, res, iterations, cfg, active,
                                  n_act)

    it_best_idx = torch.argmin(res.lengths, dim=-1)               # (B,)
    it_best_len = res.lengths.gather(-1, it_best_idx[:, None])[:, 0]
    it_best_tour = res.tours.gather(
        1, it_best_idx[:, None, None].expand(-1, 1, n))[:, 0]     # (B, n)

    improved = it_best_len < states.best_len
    best_len = torch.where(improved, it_best_len, states.best_len)
    best_tour = torch.where(improved[:, None], it_best_tour,
                            states.best_tour)

    if cfg.variant == "as":
        dep_tours = res.tours
        dep_w = tsp.per_slot(operand(q, res.lengths), 2) / res.lengths
    elif cfg.variant == "mmas":
        if cfg.mmas_best == "global":
            dep_tours, dep_len = best_tour[:, None, :], best_len
        else:
            dep_tours, dep_len = it_best_tour[:, None, :], it_best_len
        dep_w = (operand(q, dep_len) / dep_len)[:, None]
    elif cfg.variant == "acs":
        dep_tours = best_tour[:, None, :]
        rho_q = rho * q if h is not None else floatops.const(rho * q,
                                                              best_len)
        dep_w = (rho_q / best_len)[:, None]
    else:
        raise ValueError(f"unknown variant {cfg.variant}")

    if cfg.use_pallas:
        from ..kernels import ops as kops
        tau = kops.pheromone_update(tau_full, dep_tours, dep_w, rho,
                                    n_actual=n_act, active=active)
    else:
        rho0 = rho if h is None else h.rho[0]
        tau = pheromone.update(tau_full[0], dep_tours[0], dep_w[0], rho0,
                               strategy=cfg.deposit, tile=cfg.deposit_tile,
                               n_actual=None if problem.n_actual is None
                               else problem.n_actual[0])[None]

    # MMAS/ACS normalisations use the real city count of padded instances.
    clamp = None
    if cfg.variant == "mmas":
        tau_min, tau_max = mmas_bounds(best_len, cfg, n, n_act, q, rho)
        tau = torch.clamp(tau, min=tsp.per_slot(tau_min, 3),
                          max=tsp.per_slot(tau_max, 3))
        clamp = (tau_min, tau_max)
    elif cfg.variant == "acs":
        # Parallel-ACS local rule: decay edges crossed this iteration.
        n_eff = floatops.const(n, best_len) if n_act is None \
            else n_act.to(torch.float32)
        f, t = pheromone.tour_edges(res.tours, n_act)
        tau0 = operand(q, best_len) / (
            n_eff * torch.maximum(best_len, floatops.const(1e-9, best_len)))
        ew = None
        if n_act is not None:
            # phantom-tail crossings must not decay (multiplicity 0)
            idx = torch.arange(n, device=tau.device)
            ew = (idx < n_act[:, None, None]).to(tau.dtype)
            ew = ew.expand(res.tours.shape).reshape(n_slots, -1)
        tau = pheromone.local_update_acs(
            tau, f.reshape(n_slots, -1), t.reshape(n_slots, -1), cfg.xi,
            tau0, w=ew)

    # quantise-on-store: the next resident payload; metrics below read the
    # exact fp32 tau of this step, before the store rounds it
    tau_store = tau
    if quantised:
        tau_store = quant.requantise(tau, states.tau, cfg.tau_dtype,
                                     quant.round_key(cfg.tau_round,
                                                     ks[:, 2]))

    new_states = ColonyState(tau_store, best_tour, best_len,
                             states.iteration + 1, key)
    if not cfg.metrics:
        return new_states, it_best_len
    from ..obs import metrics as obs_metrics
    mets = obs_metrics.step_metrics(
        res.lengths, it_best_len, best_len, improved, tau, clamp,
        pre_ls_lengths)
    return new_states, it_best_len, mets


def colony_step(problem: Problem, state: ColonyState,
                cfg: ACOConfig) -> tuple:
    """One full ACO iteration: construct m tours, update pheromone, track
    best.  Returns (new_state, iteration_best_length); with
    ``cfg.metrics``, (new_state, iteration_best_length, obs.StepMetrics).
    The metrics are read-only reductions over this step's intermediates:
    no extra draw, no reordering, so the state is bitwise the same.

    The B = 1 case of ``colony_step_batch``: one instance is a stack of
    one, so a batched step and a solo step run the same arithmetic."""
    stacked = Problem(
        problem.dist[None], problem.eta[None], problem.nn[None],
        None if problem.n_actual is None else (int(problem.n_actual),),
        None if problem.hyper is None else
        Hyper(*(x[None] for x in problem.hyper)))
    out = colony_step_batch(stacked, tree.map(lambda x: x[None], state), cfg)
    return tuple(tree.index(o, 0) for o in out)


def run(instance: tsp.TSPInstance, cfg: ACOConfig,
        state: Optional[ColonyState] = None,
        device: _device.DeviceLike = None,
        checkpoint_cb=None, checkpoint_every: int = 0) -> ColonyState:
    """Python-loop driver over ``cfg.iterations`` colony iterations; on the
    state's device when a state is given, else on ``device``.

    ``cfg.sparse=True`` routes to the O(n·k) paged representation
    (``sparse.run_sparse``) and returns a ``SparseColonyState``: the same
    best_tour/best_len/iteration/key fields, paged tau instead of (n, n).
    """
    if cfg.sparse:
        from .. import sparse as sparse_mod
        return sparse_mod.run_sparse(instance, cfg, state, device=device,
                                     checkpoint_cb=checkpoint_cb,
                                     checkpoint_every=checkpoint_every)
    dev = state.key.device if state is not None and device is None \
        else _device.resolve(device)
    problem = make_problem(instance, cfg.nn_k, dev)
    if state is None:
        state = init_colony(instance, cfg, device=dev)
    start = int(state.iteration)
    for i in range(start, cfg.iterations):
        state = colony_step(problem, state, cfg)[0]
        if checkpoint_cb and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_cb(state)
    return state


def run_scan(problem: Problem, state: ColonyState, cfg: ACOConfig,
             iterations: int) -> tuple:
    """Multi-iteration driver: (state, it_best per iteration).  With
    ``cfg.metrics`` the second element is ``(it_best, StepMetrics)``, every
    field stacked over iterations, ``stagnation`` stamped from the loop's
    own count of non-improving iterations."""
    it_best, rows = [], []
    since = torch.zeros((), dtype=torch.int32, device=state.key.device)
    for _ in range(iterations):
        out = colony_step(problem, state, cfg)
        state = out[0]
        it_best.append(out[1])
        if cfg.metrics:
            m = out[2]
            since = torch.where(m.improved > 0, torch.zeros_like(since),
                                since + 1)
            rows.append(m._replace(stagnation=since))
    if not cfg.metrics:
        return state, torch.stack(it_best)
    from ..obs import metrics as obs_metrics
    return state, (torch.stack(it_best), obs_metrics.stack(rows))
