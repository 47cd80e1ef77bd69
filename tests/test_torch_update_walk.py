"""Port parity for the tours-driven pheromone update and the sparse walk.

- ``pheromone_update_tours`` (the card's row-owner kernel, K2 from tours):
  a pure-torch emulation of its order -- evaporate, then per ant in order
  add at each city's next tour neighbour, then per ant in order at its
  previous one -- is bitwise ``ops.pheromone_update`` on the CPU, which is
  what the kernel is held to on the card; against the reference's
  ``repro.kernels.ops.pheromone_update`` (Pallas, interpret mode) one
  deposit per cell at rho 0.5 is bitwise, and the rest is rtol 1e-5 /
  atol 1e-7, the tolerance the port's kernel route already has against
  the reference's (tests/test_torch_aco.py): the one-hot reduction sums
  several deposits in another order, and at rho 0.1 the reference's
  compiled evaporation differs by an ulp in some cells.
- ``draw_at_plain`` (the walk kernel's pointwise draw): bitwise the
  full-width ``sampling.uniform`` / ``counter_uniform`` at the same (ant,
  city) pairs, and through them ``jax.random.uniform``; ids < 0 draw 0.
- A pure-torch emulation of the walk kernel's per-ant step (draws at the
  candidates only, the fallback scan only for ants without a selectable
  candidate) is bitwise ``sparse_walk_plain``, the host loop of plain
  steps: cities, edge lengths, ``visited`` and fallback counts, over
  float32, int8 and bf16 pages, the three selection modes, both draw
  modes, a padded instance and Partial-ACO's start.
- The new launchers refuse CPU tensors, wrong dtypes and wrong shapes.
The kernels against these on the card are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import floatops, quant, sampling  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from repro_torch.kernels import sparse_select as ss  # noqa: E402
from repro_torch.kernels.choice_info import ipow  # noqa: E402
from repro_torch.kernels.tour_select import transform  # noqa: E402
from repro_torch.sparse import construct, store  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

MODES = ["iroulette", "greedy", "gumbel"]


# ------------------------------------------------- K2 from tours (row owner)

def row_owner_update(tau, tours, w, rho, n_actual=None):
    """The kernel's order in plain torch: decay * tau rounded alone, then
    the forward deposits (row c -> c's next city) of ants 0..m-1, then the
    reverse ones (row c -> c's previous city); positions >= n_actual
    deposit nothing, the closing edge leaves position n_actual - 1."""
    n = tau.shape[0]
    n_eff = n if n_actual is None else n_actual
    out = (floatops.const(float(np.float32(1.0 - rho)), tau) * tau).clone()
    flat = out.view(-1)
    p = torch.arange(n_eff)
    nxt = torch.where(p == n_eff - 1, 0, p + 1)
    prv = torch.where(p == 0, n_eff - 1, p - 1)
    t = tours.long()
    for neighbour in (nxt, prv):
        for a in range(tours.shape[0]):
            cells = t[a, p] * n + t[a, neighbour]   # distinct within an ant
            flat[cells] = flat[cells] + w[a]
    return out


def _tours(rng, m, n, n_actual):
    real = n if n_actual is None else n_actual
    return np.stack([np.concatenate([rng.permutation(real),
                                     np.arange(real, n)])
                     for _ in range(m)]).astype(np.int32)


@pytest.mark.parametrize("m,n_actual", [(9, None), (9, 19), (1, None),
                                        (1, 19)])
@pytest.mark.parametrize("rho", [0.1, 0.5])
def test_row_owner_order_is_the_cpu_update(m, n_actual, rho):
    n = 24
    rng = np.random.default_rng(m * 100 + (n_actual or 0))
    tau = torch.tensor((rng.random((n, n)) * 1e-2).astype(np.float32))
    tours = torch.tensor(_tours(rng, m, n, n_actual))
    # few cities, many ants: most cells of the AS case get several deposits
    w = torch.tensor((rng.random(m) * 1e-2 + 1e-3).astype(np.float32))
    want = ops.pheromone_update(tau, tours, w, rho, n_actual=n_actual)
    assert_bitwise(row_owner_update(tau, tours, w, rho, n_actual), want,
                   "row-owner order")
    assert_bitwise(pu.pheromone_update_tours_plain(tau, tours, w, rho,
                                                   n_actual), want, "plain")
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    ref = jops.pheromone_update(tau.numpy(), tours.numpy(), w.numpy(), rho,
                                n_actual=na)
    if m == 1 and rho == 0.5:
        assert_bitwise(ref, want, "one deposit per cell vs the reference")
    else:
        np.testing.assert_allclose(np.asarray(ref), want.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_row_owner_order_at_the_paper_size():
    """n = m = 1002 AS (2 M deposits): the CPU index_add_ still sums in
    index order, so the kernel's order is its order there too."""
    n = m = 1002
    rng = np.random.default_rng(5)
    tau = torch.tensor((rng.random((n, n)) * 1e-2).astype(np.float32))
    tours = torch.tensor(_tours(rng, m, n, None))
    w = torch.tensor((rng.random(m) * 1e-4).astype(np.float32))
    assert_bitwise(row_owner_update(tau, tours, w, 0.5),
                   ops.pheromone_update(tau, tours, w, 0.5), "n = m = 1002")


# ------------------------------------------------- the pointwise draw

@pytest.mark.parametrize("draw_mode", ["packed", "counter"])
@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_draw_at_plain_is_the_full_draw(draw_mode, seed):
    m, n = 13, 57
    key = sampling.prng_key(seed)
    rng = np.random.default_rng(seed)
    ants = torch.tensor(rng.integers(0, m, (m, 9)))
    cities = torch.tensor(rng.integers(-2, n, (m, 9)).astype(np.int32))
    got = ss.draw_at_plain(key, ants, cities, n, draw_mode)
    if draw_mode == "counter":
        full = sampling.counter_uniform(key, (m, n), 1e-6, 1.0)
    else:
        full = sampling.uniform(key, (m, n), 1e-6, 1.0)
        jfull = jax.random.uniform(jax.random.PRNGKey(seed), (m, n),
                                   jnp.float32, minval=1e-6, maxval=1.0)
        assert_bitwise(jfull, full, "uniform vs jax.random.uniform")
    real = cities >= 0
    want = torch.where(real, full[ants, cities.clamp_min(0).long()],
                       torch.zeros(()))
    assert_bitwise(want, got, f"{draw_mode} draw at (ant, city)")
    assert bool((got[~real] == 0).all()) and bool(real.any())


# ------------------------------------------------- the walk, per ant

def _page(problem, tau, ovf_city, ovf_tau, cur, ewt):
    """The kernel's page: k stored candidates, then the overflow slots with
    their lazy distance and eta; the payload dequantised per position."""
    q, scale = ss._payload(tau)
    oq, oscale = ss._payload(ovf_tau)
    c = cur.long()
    oc = ovf_city[c]
    oc = torch.where(oc >= 0, oc, cur[:, None])
    od = store.lazy_pair(problem.coords, cur[:, None].expand(oc.shape), oc,
                         ewt)
    oe = floatops.const(1.0, od) / torch.maximum(od,
                                                 floatops.const(1e-10, od))
    tq = quant.dequantise_rows(q[c], None if scale is None else scale[c])
    toq = quant.dequantise_rows(oq[c], None if oscale is None else oscale[c])
    return (torch.cat([problem.cand[c], oc], -1),
            torch.cat([tq, toq], -1),
            torch.cat([problem.cand_eta[c], oe], -1),
            torch.cat([problem.cand_dist[c], od], -1))


def walk_emulation(problem, tau, ovf_city, ovf_tau, start, visited, keys,
                   selection, ewt, draw_mode, n_actual=None):
    """The walk kernel's step in plain torch: draw only at the page's
    cities, select, scan for the nearest unvisited city only where no
    candidate is selectable."""
    m, n = visited.shape
    ants = torch.arange(m)
    cur = start.clone()
    cities_out, dist_out = [], []
    fallbacks = torch.zeros(m, dtype=torch.int32)
    for s in range(keys.shape[0]):
        t = s + 1
        if n_actual is not None and t >= n_actual:
            nxt = torch.full((m,), t, dtype=torch.int32)
            d = torch.zeros(m)
        else:
            cities, tv, eta, dist = _page(problem, tau, ovf_city, ovf_tau,
                                          cur, ewt)
            real = cities >= 0
            keep = ~(visited[ants[:, None], cities.clamp_min(0).long()]
                     & real)
            u = (torch.zeros(cities.shape) if selection == "greedy" else
                 ss.draw_at_plain(keys[s], ants[:, None].expand_as(cities),
                                  cities, n, draw_mode))
            w = ipow(tv, 1.0) * ipow(eta, 2.0)
            v = transform(w, keep.to(w.dtype), u, selection)
            pos = torch.argmax(v, -1)
            have = (w * keep).sum(-1) > 0
            nxt = cities[ants, pos].clone()
            d = dist[ants, pos].clone()
            for a in torch.nonzero(~have).flatten().tolist():
                row = store.lazy_rows(problem.coords, cur[a:a + 1], ewt)[0]
                bad = visited[a].clone()
                if n_actual is not None:
                    bad[n_actual:] = True
                j = int(torch.argmin(torch.where(bad, float("inf"), row)))
                nxt[a] = j
                d[a] = store.lazy_pair(problem.coords, cur[a:a + 1],
                                       torch.tensor([j]), ewt)[0]
                fallbacks[a] += 1
        visited[ants, nxt.long()] = True
        cur = nxt.to(torch.int32)
        cities_out.append(cur)
        dist_out.append(d)
    return torch.stack(cities_out), torch.stack(dist_out), fallbacks


def _walk_operands(n, k, o, m, tau_dtype, seed, n_pad=None, partial=False):
    return ss.walk_operands(n, m, k, o, tau_dtype, torch.device("cpu"), seed,
                            n_pad, 9 if partial else None)


WALK_CASES = [
    # (tau_dtype, selection, draw_mode, n_pad, partial)
    ("fp32", "iroulette", "packed", None, False),
    ("fp32", "gumbel", "counter", None, False),
    ("fp32", "greedy", "packed", None, False),
    ("int8", "iroulette", "counter", None, False),
    ("bf16", "gumbel", "packed", None, False),
    ("fp32", "iroulette", "packed", 47, False),
    ("int8", "iroulette", "packed", None, True),
]


@pytest.mark.parametrize("tau_dtype,selection,draw_mode,n_pad,partial",
                         WALK_CASES)
def test_walk_emulation_is_the_plain_walk(tau_dtype, selection, draw_mode,
                                          n_pad, partial):
    n, k, o, m = 40, 4, 3, 6
    ops_ = _walk_operands(n, k, o, m, tau_dtype, 3, n_pad, partial)
    problem, tau, ovf_city, ovf_tau, start, visited, keys = ops_
    n_act = problem.n_actual
    vis_w = visited.clone()
    want = ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau, start,
                                vis_w, keys, selection, 1.0, 2.0, "EUC_2D",
                                draw_mode, n_act)
    vis_e = visited.clone()
    got = walk_emulation(problem, tau, ovf_city, ovf_tau, start, vis_e, keys,
                         selection, "EUC_2D", draw_mode, n_act)
    for g, w_, what in zip(got, want, ("cities", "lengths", "fallbacks")):
        assert_bitwise(w_, g, what)
    assert torch.equal(vis_w, vis_e)
    assert int(want[2].sum()) > 0          # the page-fault path is taken


def test_ops_sparse_walk_on_cpu_is_the_host_loop():
    """On CPU tensors the route's walk is the plain host loop, counting no
    launch; ``walk.fallbacks`` adds the per-ant counts."""
    problem, tau, ovf_city, ovf_tau, start, visited, keys = _walk_operands(
        30, 4, 2, 5, "fp32", 4)
    vis_a, vis_b = visited.clone(), visited.clone()
    ops.reset_launch_counts()
    construct.walk.fallbacks = 0
    steps, dsteps = construct.walk(problem, tau, ovf_city, ovf_tau, start,
                                   vis_a, keys, 5, "iroulette", 1.0, 2.0,
                                   "EUC_2D", True, "packed")
    want = ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau, start,
                                vis_b, keys, "iroulette", 1.0, 2.0, "EUC_2D")
    assert torch.equal(steps, want[0]) and torch.equal(dsteps, want[1])
    assert torch.equal(vis_a, vis_b)
    assert int(construct.walk.fallbacks) == int(want[2].sum())
    assert steps.shape == (29, 5) and steps.dtype == torch.int32
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


class _OnCard:
    """A CPU tensor that reports a CUDA device: it reaches the launchers'
    dtype and shape checks, which run before anything touches a card."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


def test_new_launchers_refuse_cpu_tensors_and_bad_inputs():
    """No fallback: CPU tensors are refused, and so are wrong dtypes,
    shapes and options, before any launch."""
    tau = torch.rand(9, 9)
    tours = torch.stack([torch.randperm(9) for _ in range(3)]).int()
    w = torch.rand(3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pu.pheromone_update_tours(tau, tours, w, 0.5)
    C = _OnCard
    with pytest.raises(TypeError, match="int32"):
        pu.pheromone_update_tours(C(tau), C(tours.long()), C(w), 0.5)
    with pytest.raises(ValueError, match="shape"):
        pu.pheromone_update_tours(C(tau), C(tours), C(w[:2]), 0.5)
    with pytest.raises(ValueError, match="shape"):
        pu.pheromone_update_tours(C(tau[:, :8]), C(tours), C(w), 0.5)
    with pytest.raises(ValueError, match="n_actual"):
        pu.pheromone_update_tours(C(tau), C(tours), C(w), 0.5, n_actual=10)

    operands = _walk_operands(20, 4, 2, 3, "int8", 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.sparse_walk(*operands)
    problem, tq, ovf_city, ovf_tau, start, visited, keys = operands
    on = dict(problem=store.SparseProblem(*(C(x) for x in problem[:4])),
              tau=quant.QuantTau(*(C(x) for x in tq)),
              ovf_city=C(ovf_city), ovf_tau=quant.QuantTau(
                  *(C(x) for x in ovf_tau)),
              start=C(start), visited=C(visited), keys=C(keys))
    for bad, err, match in (
            (dict(selection="roulette"), ValueError, "roulette"),
            (dict(draw_mode="stream"), ValueError, "draw_mode"),
            (dict(ewt="GEO"), ValueError, "edge_weight_type"),
            (dict(visited=C(visited.to(torch.uint8))), TypeError, "bool"),
            (dict(keys=C(keys[:, :1].contiguous())), ValueError, "shape"),
            (dict(start=C(start.long())), TypeError, "int32"),
            (dict(tau=quant.QuantTau(C(tq.q), C(tq.scale[:5]), C(tq.err))),
             ValueError, "shape"),
            (dict(ovf_tau=C(ovf_tau.q.to(torch.bfloat16))), TypeError,
             "int8")):
        kw = {**on, **{k: v for k, v in bad.items()
                       if k in on}}
        opts = {k: v for k, v in bad.items() if k not in on}
        with pytest.raises(err, match=match):
            ss.sparse_walk(kw["problem"], kw["tau"], kw["ovf_city"],
                           kw["ovf_tau"], kw["start"], kw["visited"],
                           kw["keys"], **opts)
