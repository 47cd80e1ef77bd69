"""Distributed ACO over a mesh of torch devices.

The PyTorch port of ``repro.core.islands``.  Two composable levels of
parallelism, the paper's two stages lifted from the chip to the mesh:

1. **Island model** over the ``data`` (and ``pod``) axes: each position
   runs an independent colony; every ``exchange_every`` local iterations
   the islands (a) migrate their best tour around a ``ppermute`` ring (an
   immigrant better than the local best replaces it and deposits like an
   elite ant, polished first by local search when the colony runs it) and
   (b) optionally mix pheromone toward the population mean,
   ``tau <- (1 - lam) tau + lam mean``.  The exchanges are the only
   synchronisation points.

2. **City-sharded colony** over the ``model`` axis: the choice matrix,
   tabu mask and pheromone matrix are column-sharded; each shard proposes
   a partial best next city per ant and two (m,) reductions (``pmax`` of
   the value, then ``pmin`` of the index among the holders) pick the
   winner, the paper's Fig. 1 tile-then-reduce with a whole device as the
   tile.  Tours are replicated and each shard deposits into its own
   column slab, on the kernel route through the edge-stream
   ``pheromone_update`` kernel.  With ``ants_axis`` the ants are split
   over a second axis as well and the slab deposits are summed over it.

The reference is one process driving every device of its mesh through
``shard_map``; so is the port.  Each position's work is queued on that
position's device by this process (``aco.run_scan`` on the kernel route:
one ``fused_walk`` and one ``pheromone_update_tours`` launch per island
iteration), and the collectives of ``core/collectives.py`` move tensors
between positions.  A position may repeat a device, so a 4-island mesh
runs on one card or, as ``[cpu] * 4``, on the CPU.

Island states travel as a stacked ``aco.ColonyState`` (leading island
axis, on the mesh's first position), as the reference's sharded stack
reads back; ``run_islands`` also takes a list of per-position states.
``global_best`` takes the arg-min over the islands on the host and then
that island's tour.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from .. import tree
from ..analysis import ops
from . import aco, collectives, floatops, pheromone, quant, sampling
from . import strategies, tsp


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    aco: aco.ACOConfig = dataclasses.field(default_factory=aco.ACOConfig)
    exchange_every: int = 8       # local iterations between exchanges
    rounds: int = 4               # number of exchange rounds
    mix_lambda: float = 0.1       # pheromone mixing toward population mean
    migrate: bool = True          # best-tour ring migration
    elite_weight: float = 1.0     # immigrant deposit scale


def _quantised_route(msg: str):
    from ..kernels import ops as kops
    return kops.UnsupportedKernelRoute(msg)


# --------------------------------------------------------------------------
# Island model (pod/data axes)
# --------------------------------------------------------------------------

def init_island_states(instance: tsp.TSPInstance, cfg: IslandConfig,
                       n_islands: int, seed0: int = 0,
                       device: _device.DeviceLike = None) -> aco.ColonyState:
    """Stacked ColonyState with a leading island axis; island i seeded
    ``seed0 + i``."""
    dev = _device.resolve(device)
    return tree.stack([aco.init_colony(instance, cfg.aco, seed=seed0 + i,
                                       device=dev)
                       for i in range(n_islands)])


def scatter_islands(state: aco.ColonyState,
                    devices: Sequence[torch.device]) -> list:
    """A stacked island state -> one ColonyState per position, island i
    on ``devices[i]``."""
    return [tree.map(lambda x: x[i].to(dev), state)
            for i, dev in enumerate(devices)]


def gather_islands(states: Sequence[aco.ColonyState],
                   device: torch.device) -> aco.ColonyState:
    """Per-position island states -> one stacked state on ``device``."""
    return tree.map(lambda *xs: torch.stack([x.to(device) for x in xs]),
                    *states)


def _exchange(states: list, problems: list, cfg: IslandConfig,
              axis: Union[str, tuple], mesh) -> list:
    """Ring migration + pheromone mixing over one state per position."""
    ax = (axis,) if isinstance(axis, str) else tuple(axis)
    if collectives.axis_size(ax, mesh) == 1:
        return states
    new_tau = [s.tau for s in states]
    best_tour = [s.best_tour for s in states]
    best_len = [s.best_len for s in states]
    if cfg.migrate:
        # flattened multi-axis ring: successor along the last axis
        sz = mesh.shape[ax[-1]]
        perm = [(i, (i + 1) % sz) for i in range(sz)]
        imm_tour = collectives.ppermute(best_tour, ax[-1], perm, mesh)
        imm_len = collectives.ppermute(best_len, ax[-1], perm, mesh)
        for p, st in enumerate(states):
            # a leading axis of one: the immigrant is a colony of one ant
            it, il = imm_tour[p][None], imm_len[p][None]
            if cfg.aco.local_search != "none":
                # polish the immigrant before it competes and deposits
                it, il = aco.polish_tours(problems[p], it, cfg.aco)
            better = il < st.best_len
            best_tour[p] = torch.where(better, it[0], st.best_tour)
            best_len[p] = torch.where(better, il, st.best_len)[0]
            w = floatops.const(cfg.elite_weight * cfg.aco.q, il) / \
                torch.maximum(il, floatops.const(1e-9, il))
            dep = pheromone.deposit(st.tau.shape[-1], it, w, "scatter")
            new_tau[p] = st.tau + torch.where(better, dep,
                                              torch.zeros_like(dep))
    if cfg.mix_lambda > 0.0:
        # (1 - lam) * tau + lam * mean with the first product fused into
        # the add, one rounding, as XLA compiles the reference's exchange
        mean = collectives.pmean(new_tau, ax, mesh)
        lam = cfg.mix_lambda
        new_tau = [torch.addcmul(floatops.const(lam, t) * mu,
                                 floatops.const(1 - lam, t), t)
                   for t, mu in zip(new_tau, mean)]
    return [aco.ColonyState(t, bt, bl, s.iteration, s.key)
            for t, bt, bl, s in zip(new_tau, best_tour, best_len, states)]


def run_islands(instance: tsp.TSPInstance, cfg: IslandConfig, mesh,
                island_axes: tuple = ("data",),
                state: Union[aco.ColonyState, Sequence[aco.ColonyState],
                             None] = None,
                checkpoint_cb=None) -> aco.ColonyState:
    """Run the island model with one island per position along
    ``island_axes`` (other axes at coordinate 0).  ``state``: a stacked
    island state or one state per position (default fresh islands seeded
    0, 1, ...).  ``checkpoint_cb(stacked_state, round)`` after each round.
    Returns the stacked island states on the first position's device."""
    if quant.is_quantised(cfg.aco.tau_dtype):
        raise _quantised_route(
            "the island model cannot run over a quantised pheromone store "
            f"(tau_dtype={cfg.aco.tau_dtype!r}): immigrant deposits and "
            "pmean trail mixing operate on raw fp32 tau leaves. Run "
            "tau_dtype='fp32' for islands, or use the engine/streaming "
            "routes for quantised colonies.")
    sub = mesh.submesh(island_axes)
    devs = sub.device_list()
    home = devs[0]
    if state is None:
        state = init_island_states(instance, cfg, len(devs), device=home)
    states = scatter_islands(state, devs) \
        if isinstance(state, aco.ColonyState) else list(state)
    if len(states) != len(devs):
        raise ValueError(f"{len(states)} island states for {len(devs)} "
                         "positions")
    by_dev = {}
    for d in devs:
        if d not in by_dev:
            by_dev[d] = aco.make_problem(instance, cfg.aco.nn_k, d)
    problems = [by_dev[d] for d in devs]
    for r in range(cfg.rounds):
        # every island's iterations are queued before the exchange, which
        # reads nothing back either
        states = [aco.run_scan(p, s, cfg.aco, cfg.exchange_every)[0]
                  for p, s in zip(problems, states)]
        states = _exchange(states, problems, cfg, island_axes, sub)
        if checkpoint_cb is not None:
            checkpoint_cb(gather_islands(states, home), r)
    return gather_islands(states, home)


def global_best(state: Union[aco.ColonyState, Sequence[aco.ColonyState]]
                ) -> tuple[np.ndarray, float]:
    """(best tour, best length) over the islands: the arg-min of the
    islands' lengths on the host, then that island's tour."""
    if not isinstance(state, aco.ColonyState):
        state = gather_islands(state, torch.device("cpu"))
    lens = state.best_len.cpu().numpy()
    i = int(np.argmin(lens))
    return state.best_tour[i].cpu().numpy(), float(lens[i])


# --------------------------------------------------------------------------
# City-sharded colony (model axis): the paper's tiling at mesh level
# --------------------------------------------------------------------------

class ShardedColonyState(NamedTuple):
    tau: list                 # per mesh position its (n, n/S) column slab
    best_tour: torch.Tensor   # (n,) replicated: one copy, first position
    best_len: torch.Tensor    # ()
    iteration: torch.Tensor   # ()
    key: torch.Tensor         # (2,)


def shard_columns(x: torch.Tensor, mesh, axis: str = "model") -> list:
    """A full (n, n) matrix -> per mesh position (row-major) its column
    slab ``x[:, s*n/S:(s+1)*n/S]`` on that position's device, where s is
    the position's index along ``axis``."""
    s = mesh.shape[axis]
    nl = x.shape[-1] // s
    return [x[:, j * nl:(j + 1) * nl].to(dev, copy=True)
            for j, dev in zip(collectives.axis_index(axis, mesh),
                              mesh.device_list())]


def unshard_columns(slabs: Sequence[torch.Tensor], mesh,
                    axis: str = "model") -> torch.Tensor:
    """Per-position column slabs -> the full matrix on the first
    position's device (the slabs of coordinate 0 along the other axes)."""
    home = slabs[0].device
    idx = collectives.axis_index(axis, mesh)
    first = {}
    for j, t in zip(idx, slabs):
        first.setdefault(j, t)
    return torch.cat([first[j].to(home) for j in range(mesh.shape[axis])],
                     dim=1)


def init_sharded_colony(instance: tsp.TSPInstance, cfg: aco.ACOConfig,
                        mesh, axis: str = "model") -> ShardedColonyState:
    n = instance.n
    s = mesh.shape[axis]
    if n % s:
        raise ValueError(f"n={n} must divide model axis {s}")
    home = mesh.device_list()[0]
    tau0 = float(np.float32(aco.initial_tau(instance, cfg)))
    nl = n // s
    return ShardedColonyState(
        tau=[torch.full((n, nl), tau0, dtype=torch.float32, device=d)
             for d in mesh.device_list()],
        best_tour=torch.arange(n, dtype=torch.int32, device=home),
        best_len=torch.tensor(np.float32(np.inf), device=home),
        iteration=torch.tensor(0, dtype=torch.int32, device=home),
        key=sampling.prng_key(cfg.seed, home),
    )


_INT_MAX = 2 ** 31 - 1


def _by_device(devices: Sequence[torch.device]) -> list[list[int]]:
    """Mesh positions grouped by device, each group in position order."""
    groups: dict = {}
    for p, d in enumerate(devices):
        groups.setdefault(d, []).append(p)
    return list(groups.values())


def _sharded_construct(dist_l: list, choice_l: list, keys: list, m: int,
                       n: int, nl: int, axis: str, mesh
                       ) -> tuple[list, list]:
    """Construct m tours per position with column-sharded choice slabs.

    Positions of one group along ``axis`` hold the same key and build the
    same tours; each owns the columns ``[s*nl, (s+1)*nl)``.  The positions
    that share a device step as one (P, ...) stack (every operation is
    per position, so row p is bitwise that position alone), which keeps
    the host's launches per step independent of how many positions repeat
    a device.  Returns per position (tours (m, n) int32, lengths (m,))."""
    sidx = collectives.axis_index(axis, mesh)
    npos = len(dist_l)
    groups = _by_device([d.device for d in dist_l])
    st = []                     # per group: its stacked state
    for g in groups:
        dev = dist_l[g[0]].device
        with ops.at_position(*g):
            col0 = torch.tensor([[sidx[p] * nl] for p in g],
                                dtype=torch.int32, device=dev)    # (P, 1)
            ks = sampling.split(torch.stack([keys[p] for p in g]))
            start = sampling.randint(ks[:, 0], (m,), 0, n)        # (P, m)
            own = (start >= col0) & (start < col0 + nl)
            loc = torch.clamp(start - col0, 0, nl - 1).long()
            vis = torch.zeros((len(g), m, nl), dtype=torch.bool, device=dev)
            vis.scatter_(2, loc[..., None], own[..., None])
            tours = torch.empty((len(g), m, n), dtype=torch.int32,
                                device=dev)
            tours[:, :, 0] = start
            st.append(dict(
                dist=torch.stack([dist_l[p] for p in g]).reshape(len(g), -1),
                choice=torch.stack([choice_l[p] for p in g]),
                sidx=torch.tensor([sidx[p] for p in g], dtype=torch.int64,
                                  device=dev),
                col0=col0, kc=ks[:, 1], start=start, cur=start, vis=vis,
                lens=torch.zeros((len(g), m), dtype=torch.float32,
                                 device=dev),
                tours=tours))
    for t in ops.trip(range(1, n)):
        pv, pi = [None] * npos, [None] * npos
        for g, a in zip(groups, st):
            with ops.at_position(*g):
                k = sampling.fold_in_rows(sampling.fold_in_rows(a["kc"], t),
                                          a["sidx"])
                rows = a["cur"].long()[..., None].expand(-1, -1, nl)
                w = a["choice"].gather(1, rows) * (~a["vis"])
                v = w * sampling.uniform(k, (m, nl), 1e-6, 1.0, w.dtype)
                vmax = v.max(dim=2).values.to(torch.float32)
                vidx = v.argmax(dim=2).to(torch.int32) + a["col0"]
            for r, p in enumerate(g):
                pv[p], pi[p] = vmax[r], vidx[r]
        # the paper's final argmax as two (m,) reductions over the shards:
        # the largest value, then the smallest index among its holders
        gmax = collectives.pmax(pv, axis, mesh)
        cand = []
        for p, (v, x, i) in enumerate(zip(pv, gmax, pi)):
            with ops.at_position(p):
                cand.append(torch.where(v == x, i,
                                        torch.full_like(i, _INT_MAX)))
        nxt = collectives.pmin(cand, axis, mesh)
        for g, a in zip(groups, st):
            with ops.at_position(*g):
                nx = torch.stack([nxt[p] for p in g])             # (P, m)
                col0 = a["col0"]
                own = (nx >= col0) & (nx < col0 + nl)
                loc = torch.clamp(nx - col0, 0, nl - 1).long()
                a["vis"].scatter_(2, loc[..., None], (a["vis"].gather(
                    2, loc[..., None]) | own[..., None]))
                # the owner of nxt's column adds the edge cur -> nxt
                dloc = a["dist"].gather(1, a["cur"].long() * nl + loc)
                a["lens"] = a["lens"] + torch.where(own, dloc,
                                                    torch.zeros_like(dloc))
                a["cur"] = nx
                a["tours"][:, :, t] = nx
    tours, lens = [None] * npos, [None] * npos
    for g, a in zip(groups, st):
        with ops.at_position(*g):
            col0, start = a["col0"], a["start"]
            ownc = (start >= col0) & (start < col0 + nl)
            dl = a["dist"].gather(1, a["cur"].long() * nl + torch.clamp(
                start - col0, 0, nl - 1).long())
            total = a["lens"] + torch.where(ownc, dl, torch.zeros_like(dl))
        for r, p in enumerate(g):
            tours[p], lens[p] = a["tours"][r], total[r]
    return tours, collectives.psum(lens, axis, mesh)


def sharded_colony_step_fn(mesh, n: int, cfg: aco.ACOConfig,
                           axis: str = "model", use_pallas: bool = False,
                           ants_axis: Optional[str] = None,
                           choice_dtype: torch.dtype = torch.float32):
    """The city-sharded colony step for this mesh and instance size:
    ``step(dist_slabs, eta_slabs, state) -> (state, iteration best)``,
    the slabs per mesh position (``shard_columns``).

    ``use_pallas=True`` deposits through the edge-stream
    ``pheromone_update`` kernel on each (n, n/S) slab, ``to`` in the
    slab's column frame and -1 outside it; otherwise through
    ``index_put_``.  ``ants_axis`` additionally splits the ants over that
    axis (m/|ants_axis| per row): the iteration best is all-gathered over
    it and the slab deposits are summed over it.  ``choice_dtype``
    bfloat16 holds the choice slabs in bfloat16 (half the bytes of each
    step's row gather): each step's draw and product are bfloat16 too,
    and each partial maximum is compared in float32 across the shards."""
    s = mesh.shape[axis]
    nl = n // s
    m = cfg.num_ants(n)
    d_ants = mesh.shape[ants_axis] if ants_axis else 1
    if m % d_ants:
        raise ValueError(f"m={m} ants do not split over {d_ants} rows")
    m_l = m // d_ants
    devs = mesh.device_list()
    sidx = collectives.axis_index(axis, mesh)
    aidx = collectives.axis_index(ants_axis, mesh) if ants_axis \
        else [0] * len(devs)
    decay = float(np.float32(1.0 - cfg.rho))

    def step(dist_l: list, eta_l: list, st: ShardedColonyState):
        choice = []
        for p, (t, e) in enumerate(zip(st.tau, eta_l)):
            with ops.at_position(p):
                choice.append(strategies.choice_matrix(
                    t, e, cfg.alpha, cfg.beta).to(choice_dtype))
        ks = sampling.split(st.key)
        key, k_t = ks[0], ks[1]
        keys = [k_t.to(d) for d in devs]
        if ants_axis:
            keys = [sampling.fold_in(k, a) for k, a in zip(keys, aidx)]
        tours, lengths = _sharded_construct(dist_l, choice, keys, m_l, n, nl,
                                            axis, mesh)
        it_len, it_tour = [], []
        for p, (tr, ln) in enumerate(zip(tours, lengths)):
            with ops.at_position(p):
                ib = torch.argmin(ln).reshape(1)    # a device index
                it_len.append(ln.index_select(0, ib)[0])
                it_tour.append(tr.index_select(0, ib)[0])
        if ants_axis:
            # global iteration-best across ant shards: a tiny all-gather
            lens_all = collectives.all_gather(it_len, ants_axis, mesh)
            tours_all = collectives.all_gather(it_tour, ants_axis, mesh)
            for p, (la, ta) in enumerate(zip(lens_all, tours_all)):
                with ops.at_position(p):
                    g = torch.argmin(la).reshape(1)
                    it_len[p] = la.index_select(0, g)[0]
                    it_tour[p] = ta.index_select(0, g)[0]
        home = st.best_len.device
        il, itr = it_len[0].to(home), it_tour[0].to(home)
        better = il < st.best_len
        best_len = torch.where(better, il, st.best_len)
        best_tour = torch.where(better, itr, st.best_tour)
        # owner-local column-slab deposit
        deps = []
        for p, (tr, ln) in enumerate(zip(tours, lengths)):
            with ops.at_position(p):
                deps.append(deposit(p, st.tau[p], tr, ln))
        if ants_axis:
            deps = collectives.psum(deps, ants_axis, mesh)
        if use_pallas or ants_axis:
            # (1 - rho) * tau + dep, one rounding (XLA's fused form)
            new_tau = []
            for p, (t, d) in enumerate(zip(st.tau, deps)):
                with ops.at_position(p):
                    new_tau.append(torch.addcmul(
                        d, floatops.const(decay, t), t))
        else:
            new_tau = deps
        return ShardedColonyState(new_tau, best_tour, best_len,
                                  st.iteration + 1, key), il

    def deposit(p: int, tau: torch.Tensor, tr: torch.Tensor,
                ln: torch.Tensor) -> torch.Tensor:
        """Position p's owner-local slab deposit: onto the evaporated
        slab where XLA scatters onto it, else the deposit alone."""
        c0 = sidx[p] * nl
        frm = tr.reshape(-1)
        to = torch.roll(tr, -1, dims=-1).reshape(-1)
        wrep = torch.repeat_interleave(floatops.const(cfg.q, ln) / ln, n)
        f2 = torch.cat([frm, to])
        t2 = torch.cat([to, frm]) - c0          # local column frame
        w2 = torch.cat([wrep, wrep])
        t2 = torch.where((t2 >= 0) & (t2 < nl), t2, torch.full_like(t2, -1))
        if use_pallas:
            from ..kernels import ops as kops
            out = kops.pheromone_update_edges(tau, f2, t2, w2, cfg.rho)
            return out - floatops.const(decay, tau) * tau
        valid = t2 >= 0
        zero = torch.zeros_like(f2)
        idx = (torch.where(valid, f2, zero).long(),
               torch.where(valid, t2, zero).long())
        w2 = torch.where(valid, w2, torch.zeros_like(w2))
        if ants_axis:
            return torch.zeros_like(tau).index_put_(idx, w2, accumulate=True)
        # XLA scatters the deposits straight onto the evaporated slab when
        # nothing sits between the two
        return (floatops.const(decay, tau) * tau).index_put_(
            idx, w2, accumulate=True)

    return step


def run_sharded_colony(instance: tsp.TSPInstance, cfg: aco.ACOConfig,
                       mesh, axis: str = "model",
                       iterations: Optional[int] = None,
                       state: Optional[ShardedColonyState] = None,
                       ants_axis: Optional[str] = None,
                       choice_dtype: torch.dtype = torch.float32
                       ) -> ShardedColonyState:
    """``iterations`` (default ``cfg.iterations``) city-sharded colony
    steps; ``cfg.use_pallas`` deposits through the edge-stream kernel,
    ``ants_axis`` splits the ants over that axis as well, and
    ``choice_dtype`` is the choice slabs' (``sharded_colony_step_fn``)."""
    if quant.is_quantised(cfg.tau_dtype):
        raise _quantised_route(
            "the city-sharded colony cannot run over a quantised pheromone "
            f"store (tau_dtype={cfg.tau_dtype!r}): tau column slabs are raw "
            "fp32 per-device shards. Run tau_dtype='fp32' on this route.")
    n = instance.n
    home = mesh.device_list()[0]
    d = torch.from_numpy(instance.distances()).to(home)
    eta = tsp.heuristic_matrix(d)
    dist_l = shard_columns(d, mesh, axis)
    eta_l = shard_columns(eta, mesh, axis)
    if state is None:
        state = init_sharded_colony(instance, cfg, mesh, axis)
    step = sharded_colony_step_fn(mesh, n, cfg, axis, cfg.use_pallas,
                                  ants_axis, choice_dtype)
    for _ in range(iterations or cfg.iterations):
        state, _ = step(dist_l, eta_l, state)
    return state
