"""Port parity for the sparse O(n·k) route: repro_torch.sparse against
repro.sparse, on the same seeded inputs (``convert`` carries states).

Contracts:

- store builders (candidates, distances, eta, tau0, NN tour), the lazy
  distances (every rounding rule) and ``sparse_tour_length``: bitwise;
- ``sparse_select_plain`` / ``sparse_select_quant_plain`` against the
  reference oracles ``ref.sparse_select`` / ``sparse_select_quant``:
  ``have`` bitwise, picks bitwise (gumbel: within the 4-ulp ``log`` rule of
  tests/test_torch_kernels.py);
- ``deposit_sparse``, ``update_sparse`` and ``local_update_acs_sparse``
  against the reference's compiled functions at rho = 0.1, bitwise;
  ``adopt_offlist`` (match, free slot, eviction, full pages) bitwise;
- whole runs (``run_sparse``, ``aco.run(sparse=True)``) against the
  reference's sparse route, pure and kernel routes, data-parallel and
  Partial-ACO, masked, fp32/int8/bf16: tours, best_len, tau, tau_def,
  overflow pages and key bitwise, with two stated exceptions where XLA's
  compiled numbers depend on shapes the port does not model (ROADMAP
  queue 3): ACS over a quantised store (dequantised tau at rtol 1e-4 /
  atol 1e-6, the reference's own quantisation tolerance) and the
  Partial-ACO delta lengths at 13 <= window+1 <= 32 (lengths ulp-close, so
  AS tau at rtol 1e-5 / atol 1e-7).  Gumbel runs: valid tours, no worse
  than the nearest-neighbour tour;
- the port's sparse route at k = n-1 equals its dense route for MMAS and
  ACS bit for bit; for AS tau is within 2 ulp, exactly as the reference's
  own sparse and dense routes differ (test_sparse.py's full-k AS cases).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.sparse import aco as jsa  # noqa: E402
from repro.sparse import pheromone as jph  # noqa: E402
from repro.sparse import store as jst  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparse_select as ss  # noqa: E402
from repro_torch.sparse import aco as tsa  # noqa: E402
from repro_torch.sparse import construct as tcon  # noqa: E402
from repro_torch.sparse import pheromone as tph  # noqa: E402
from repro_torch.sparse import store as tst  # noqa: E402
from torch_parity import assert_bitwise, to_np, ulp_distance  # noqa: E402

INSTANCES = {
    "circle": lambda: jtsp.circle_instance(24),
    "grid": lambda: jtsp.grid_instance(5),
    "random": lambda: jtsp.random_instance(40, seed=2),
}
MODES = ["iroulette", "greedy", "gumbel"]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iu":
        x = x.view(np.int16)
    return x


def _assert_tau(j, t, what, exact=True):
    """fp32 pages, or a QuantTau's payload/scale/err, bitwise; else the
    dequantised pages at the reference's quantisation tolerance."""
    if not isinstance(t, tuple):
        if exact:
            assert_bitwise(j, t, what)
        else:
            np.testing.assert_allclose(np.asarray(j), to_np(t), rtol=1e-5,
                                       atol=1e-7, err_msg=what)
        return
    if exact:
        for f in ("q", "scale", "err"):
            assert_bitwise(_bits(getattr(j, f)), _bits(getattr(t, f)),
                           f"{what} {f}")
        return
    jd = np.asarray(j.q).astype(np.float32) * (
        np.asarray(j.scale) if j.q.dtype == jnp.int8 else 1.0)
    td = t.q.float().numpy() * (t.scale.numpy()
                                if t.q.dtype == torch.int8 else 1.0)
    np.testing.assert_allclose(jd, td, rtol=1e-4, atol=1e-6, err_msg=what)


def _assert_state(sj, st, what="", tau_exact=True):
    for f in ("best_tour", "best_len", "tau_def", "ovf_city", "iteration"):
        assert_bitwise(getattr(sj, f), getattr(st, f), f"{what} {f}")
    assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key, f"{what} key")
    _assert_tau(sj.tau, st.tau, f"{what} tau", tau_exact)
    _assert_tau(sj.ovf_tau, st.ovf_tau, f"{what} ovf_tau", tau_exact)


# ------------------------------------------------------------------ store

@pytest.mark.parametrize("name,k,n_pad", [("random", 12, None),
                                          ("grid", 4, None),
                                          ("circle", 30, 29)])
def test_store_builders_bitwise(name, k, n_pad):
    """Pages (k > n-1 gives surplus self-sentinel columns), phantom rows,
    tau0 for every variant and the row-wise NN tour."""
    inst = INSTANCES[name]()
    pj = jst.make_sparse_problem(inst, k, n_pad)
    pt = tst.make_sparse_problem(ttsp.TSPInstance(
        inst.name, inst.coords, inst.edge_weight_type), k, n_pad,
        device="cpu")
    for f in ("coords", "cand", "cand_dist", "cand_eta"):
        assert_bitwise(getattr(pj, f), getattr(pt, f), f)
    assert (pj.n_actual is None) == (pt.n_actual is None)
    if pt.n_actual is not None:
        assert int(pj.n_actual) == pt.n_actual
    tour_j, len_j = jst.sparse_nearest_neighbour_tour(inst)
    tour_t, len_t = tst.sparse_nearest_neighbour_tour(inst)
    assert_bitwise(tour_j, tour_t, "NN tour")
    assert len_j == len_t
    for variant in ("as", "mmas", "acs"):
        kw = dict(variant=variant, m=10, rho=0.1)
        assert jst.sparse_initial_tau(inst, jaco.ACOConfig(**kw)) == \
            tst.sparse_initial_tau(inst, taco.ACOConfig(**kw))


@pytest.mark.parametrize("ewt", ["RAW", "EUC_2D", "CEIL_2D", "ATT"])
def test_lazy_distances_and_tour_length_bitwise(ewt):
    """The page-fault distances as the reference's jitted code computes
    them (a fused dx*dx + dy*dy, a correctly rounded sqrt), and tour
    lengths at k < n-1, where most edges are lazy."""
    rng = np.random.default_rng(3)
    inst = jtsp.TSPInstance("r", coords=rng.uniform(0, 900, (40, 2)),
                            edge_weight_type=ewt)
    pj = jst.make_sparse_problem(inst, 4)
    pt = tst.make_sparse_problem(inst, 4, device="cpu")
    a = rng.integers(0, 40, 4000).astype(np.int32)
    b = rng.integers(0, 40, 4000).astype(np.int32)
    want = jax.jit(jst.lazy_pair, static_argnames="ewt")(
        pj.coords, jnp.asarray(a), jnp.asarray(b), ewt)
    assert_bitwise(want, tst.lazy_pair(pt.coords, torch.tensor(a),
                                       torch.tensor(b), ewt), "lazy_pair")
    want = jax.jit(jst.lazy_rows, static_argnames="ewt")(
        pj.coords, jnp.asarray(a[:30]), ewt)
    assert_bitwise(want, tst.lazy_rows(pt.coords, torch.tensor(a[:30]), ewt),
                   "lazy_rows")
    tours = np.stack([rng.permutation(40) for _ in range(12)]).astype(
        np.int32)
    want = jax.jit(jst.sparse_tour_length, static_argnames="ewt")(
        pj, jnp.asarray(tours), ewt)
    assert_bitwise(want, tst.sparse_tour_length(pt, torch.tensor(tours), ewt),
                   "sparse_tour_length")


def test_resident_bytes_and_dense_bytes():
    """The same tensors as the reference, counted as the port holds them:
    its key is two int64 words, 8 bytes more than the uint32 pair."""
    inst = INSTANCES["random"]()
    kw = dict(variant="mmas", sparse=True, sparse_k=8, m=8)
    pj, pt = (jst.make_sparse_problem(inst, 8),
              tst.make_sparse_problem(inst, 8, device="cpu"))
    sj = jsa.init_sparse_colony(inst, jaco.ACOConfig(**kw))
    st = tsa.init_sparse_colony(inst, taco.ACOConfig(**kw), device="cpu")
    assert tst.resident_bytes(pt, st) == jst.resident_bytes(pj, sj) + 8
    assert tst.dense_resident_bytes(2392) == jst.dense_resident_bytes(2392)


# ------------------------------------------------------- K7's plain twin

def _select_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    tau = (rng.random((m, k)) + 0.1).astype(np.float32)
    eta = (rng.random((m, k)) + 0.1).astype(np.float32)
    cand = rng.integers(0, n, (m, k)).astype(np.int32)
    cand[1:][rng.random((m - 1, k)) < 0.1] = -1    # padding ids
    visited = rng.random((m, n)) < 0.4
    visited[0, cand[0]] = True                     # a row with no candidate
    rand = (rng.random((m, n)) * (1 - 1e-6) + 1e-6).astype(np.float32)
    return tau, eta, cand, visited, rand


def _sparse_scores(w, cand, visited, rand):
    """The reference oracle's gumbel scores in NumPy float32."""
    ants = np.arange(cand.shape[0])[:, None]
    safe = np.where(cand >= 0, cand, 0)
    gv = np.where(cand >= 0, visited[ants, safe], False)
    gr = np.where(cand >= 0, rand[ants, safe], np.float32(0))
    g = -np.log(-np.log(np.clip(gr, np.float32(1e-12),
                                np.float32(1 - 1e-7))))
    return np.where((w > 0) & ~gv, np.log(np.maximum(w, np.float32(1e-38)))
                    + g, np.float32(-1e30)).astype(np.float32)


def _assert_select(want, got, mode, w, cand, visited, rand):
    assert_bitwise(want[1], got[1], "have")
    wp, gp = np.asarray(want[0]), to_np(got[0])
    if mode != "gumbel":
        assert_bitwise(wp, gp, f"{mode} pos")
        return
    scores = _sparse_scores(w, cand, visited, rand)
    rows = np.nonzero(wp != gp)[0]
    d = ulp_distance(scores[rows, wp[rows]], scores[rows, gp[rows]])
    assert d.max(initial=0) <= 4, d


@pytest.mark.parametrize("alpha,beta", [(1.0, 2.0), (2.0, 3.0)])
@pytest.mark.parametrize("mode", MODES)
def test_sparse_select_plain_vs_reference(mode, alpha, beta):
    tau, eta, cand, visited, rand = _select_inputs(13, 9, 100, 5)
    T = [torch.tensor(x) for x in (tau, eta, cand, visited, rand)]
    want = jref.sparse_select(tau, eta, cand, visited, rand, alpha, beta,
                              mode)
    got = ss.sparse_select_plain(*T, alpha, beta, mode)
    w = (tau ** alpha * eta ** beta).astype(np.float32)
    _assert_select(want, got, mode, w, cand, visited, rand)
    assert int(got[1][0]) == 0                     # whole page visited
    # the same through ops on CPU tensors, counting no launch
    ops.reset_launch_counts()
    for a, b in zip(ops.sparse_select(*T, alpha, beta, mode), got):
        assert torch.equal(a, b)
    assert ops.launch_counts()["sparse_select"] == 0
    # int8 and bf16 page payloads against the quantised oracle
    rng = np.random.default_rng(1)
    q8 = rng.integers(-127, 128, tau.shape).astype(np.int8)
    scale = np.repeat((rng.random((13, 1)) * 1e-2).astype(np.float32), 9, 1)
    want = jref.sparse_select_quant(jnp.asarray(q8), jnp.asarray(scale), eta,
                                    cand, visited, rand, alpha, beta, mode)
    got = ss.sparse_select_quant_plain(torch.tensor(q8), torch.tensor(scale),
                                       *T[1:], alpha, beta, mode)
    wq = q8.astype(np.float32) * scale
    _assert_select(want, got, mode, (wq ** alpha * eta ** beta), cand,
                   visited, rand)
    qb = jnp.asarray(tau).astype(jnp.bfloat16)
    want = jref.sparse_select_quant(qb, None, eta, cand, visited, rand,
                                    alpha, beta, mode)
    got = ss.sparse_select_quant_plain(torch.tensor(tau).to(torch.bfloat16),
                                       None, *T[1:], alpha, beta, mode)
    wb = np.asarray(qb.astype(jnp.float32))
    _assert_select(want, got, mode, (wb ** alpha * eta ** beta), cand,
                   visited, rand)
    assert ref.sparse_select is ss.sparse_select_plain
    assert ref.sparse_select_quant is ss.sparse_select_quant_plain


def test_sparse_select_launcher_refuses_cpu_tensors():
    T = [torch.tensor(x) for x in _select_inputs(4, 5, 20, 2)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.sparse_select(*T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.sparse_select_quant(T[0].to(torch.bfloat16), None, *T[1:])


# ------------------------------------------------------------ pheromone

@pytest.mark.parametrize("m,k", [(1, 8), (10, 6), (2, 3)])
def test_deposit_and_update_bitwise(m, k):
    """One tour (2m < k: XLA scatters the deposits onto the evaporated
    trail) and several tours (it fuses the evaporation into their sum),
    with adoption, at rho = 0.1, against the reference's compiled
    update."""
    inst = INSTANCES["random"]()
    n = inst.n
    cand = np.asarray(jst.make_sparse_problem(inst, k).cand)
    rng = np.random.default_rng(m)
    tau = (rng.random((n, k)) * 1e-3 + 1e-3).astype(np.float32)
    tours = np.stack([rng.permutation(n) for _ in range(m)]).astype(np.int32)
    w = (1.0 / (rng.random(m) * 1000 + 4000)).astype(np.float32)
    ovc = np.full((n, 3), -1, np.int32)
    ovc[:5, 0] = rng.integers(0, n, 5)
    ovt = (rng.random((n, 3)) * 1e-3).astype(np.float32)
    dj, offj = jph.deposit_sparse(jnp.asarray(cand), jnp.asarray(tours),
                                  jnp.asarray(w))
    dt, offt = tph.deposit_sparse(torch.tensor(cand), torch.tensor(tours),
                                  torch.tensor(w))
    assert_bitwise(dj, dt, "deposit")
    assert_bitwise(offj, offt, "off-list stream")
    adopt = m == 1
    want = jax.jit(jph.update_sparse, static_argnames=("adopt",))(
        jnp.asarray(tau), jnp.float32(2e-4), jnp.asarray(ovc),
        jnp.asarray(ovt), jnp.asarray(cand), jnp.asarray(tours),
        jnp.asarray(w), 0.1, adopt)
    got = tph.update_sparse(torch.tensor(tau), torch.tensor(np.float32(2e-4)),
                            torch.tensor(ovc), torch.tensor(ovt),
                            torch.tensor(cand), torch.tensor(tours),
                            torch.tensor(w), 0.1, adopt)
    for name, a, b in zip(("tau", "tau_def", "ovf_city", "ovf_tau"), want,
                          got):
        assert_bitwise(a, b, name)
    xi, tau0 = 0.1, np.float32(3e-4)
    want = jax.jit(jph.local_update_acs_sparse, static_argnames=("xi",))(
        jnp.asarray(tau), jnp.float32(2e-4), jnp.asarray(ovt),
        jnp.asarray(cand), jnp.asarray(tours), xi, jnp.asarray(tau0))
    got = tph.local_update_acs_sparse(
        torch.tensor(tau), torch.tensor(np.float32(2e-4)), torch.tensor(ovt),
        torch.tensor(cand), torch.tensor(tours), xi, torch.tensor(tau0))
    assert_bitwise(want[0], got[0], "ACS local rule")


def _adopt_pair(cand, ovc, ovt, tour, w, tau_def, n_actual=None):
    want = jph.adopt_offlist(jnp.asarray(cand), jnp.asarray(ovc),
                             jnp.asarray(ovt), jnp.asarray(tour),
                             jnp.float32(w), jnp.float32(tau_def),
                             None if n_actual is None
                             else jnp.asarray(n_actual, jnp.int32))
    got = tph.adopt_offlist(torch.tensor(cand), torch.tensor(ovc),
                            torch.tensor(ovt), torch.tensor(tour),
                            torch.tensor(np.float32(w)),
                            torch.tensor(np.float32(tau_def)), n_actual)
    assert_bitwise(want[0], got[0], "ovf_city")
    assert_bitwise(want[1], got[1], "ovf_tau")
    return to_np(got[0]), to_np(got[1])


def test_adopt_offlist_match_free_and_eviction():
    """The reference's own cases (tests/test_sparse.py), then pages that
    are full, so that every row meets a match, a free slot or an
    eviction decision, unpadded and padded."""
    cand = np.asarray([[1, 2], [0, 2], [0, 1], [0, 1]], np.int32)
    ovc = np.full((4, 2), -1, np.int32)
    ovt = np.zeros((4, 2), np.float32)
    tour = np.asarray([0, 1, 2, 3], np.int32)
    oc, ot = _adopt_pair(cand, ovc, ovt, tour, 0.5, 0.1)
    assert 3 in oc[0]
    oc, ot = _adopt_pair(cand, oc, ot, tour, 0.5, 0.1)     # match adds
    assert list(oc[0]).count(3) == 1
    cand1 = np.asarray([[1], [0], [0], [0]], np.int32)
    ovc1 = np.asarray([[2], [-1], [-1], [-1]], np.int32)
    for page0 in (9.0, 0.2):                               # keep / evict
        ovt1 = np.asarray([[page0], [0], [0], [0]], np.float32)
        oc, _ = _adopt_pair(cand1, ovc1, ovt1, np.asarray([0, 3, 1, 2],
                                                          np.int32), 0.5,
                            0.1)
        assert oc[0, 0] == (2 if page0 == 9.0 else 3)
    rng = np.random.default_rng(4)
    n, k, o = 30, 3, 2
    inst = jtsp.random_instance(n, seed=8)
    cand = np.asarray(jst.make_sparse_problem(inst, k).cand)
    for n_actual in (None, 24):
        real = n if n_actual is None else n_actual
        tour = np.concatenate([rng.permutation(real),
                               np.arange(real, n)]).astype(np.int32)
        ovc = rng.integers(0, n, (n, o)).astype(np.int32)   # full pages
        ovt = (rng.random((n, o)) * 0.4).astype(np.float32)
        oc, _ = _adopt_pair(cand, ovc, ovt, tour, 0.25, 0.1, n_actual)
        assert (oc != ovc).any()                            # some evictions


# ------------------------------------------------------------ whole runs

def _runs(inst, kw):
    sj = jsa.run_sparse(inst, jaco.ACOConfig(**kw))
    st = tsa.run_sparse(inst, taco.ACOConfig(**kw), device="cpu")
    return sj, st


RUN_CASES = [
    # (instance, variant, selection, construction, use_pallas)
    (name, variant, selection, construction, use_pallas)
    for i, (variant, selection, construction, use_pallas) in enumerate(
        (v, s, c, p) for v in ("as", "mmas", "acs")
        for s in ("iroulette", "greedy")
        for c in ("data_parallel", "partial") for p in (False, True))
    for name in [sorted(INSTANCES)[i % 3]]
]


@pytest.mark.parametrize("name,variant,selection,construction,use_pallas",
                         RUN_CASES)
def test_run_sparse_bitwise(name, variant, selection, construction,
                            use_pallas):
    kw = dict(variant=variant, selection=selection,
              construction=construction, use_pallas=use_pallas,
              sparse=True, sparse_k=4 + (len(name) % 3) * 2, m=10,
              iterations=4, seed=3, rho=0.1, partial_window=6)
    _assert_state(*_runs(INSTANCES[name](), kw), "run")


@pytest.mark.parametrize("variant,tau_dtype,construction,use_pallas", [
    ("as", "int8", "data_parallel", True), ("as", "bf16", "partial", False),
    ("mmas", "int8", "partial", True), ("mmas", "bf16", "data_parallel", True),
    ("mmas", "int8", "data_parallel", False),
    ("acs", "bf16", "data_parallel", True),
    ("acs", "int8", "data_parallel", True), ("acs", "int8", "partial", False),
])
def test_run_sparse_quantised(variant, tau_dtype, construction, use_pallas):
    """int8/bf16 pages and overflow pages: bitwise, except ACS (see the
    module docstring)."""
    kw = dict(variant=variant, tau_dtype=tau_dtype, construction=construction,
              use_pallas=use_pallas, sparse=True, sparse_k=6, m=10,
              iterations=4, seed=5, rho=0.1, partial_window=6)
    sj, st = _runs(INSTANCES["random"](), kw)
    _assert_state(sj, st, "quantised", tau_exact=variant != "acs")


@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_step_masked_bitwise(variant, use_pallas):
    """A padded problem (phantom rows, n_actual) through the data-parallel
    step, MMAS far enough that the clamp's tau_min is reached."""
    inst = INSTANCES["circle"]()
    n_pad = inst.n + 7
    kw = dict(variant=variant, use_pallas=use_pallas, sparse=True,
              sparse_k=6, m=10, seed=3, rho=0.1)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jst.make_sparse_problem(inst, 6, n_pad)
    pt = tst.make_sparse_problem(inst, 6, n_pad, device="cpu")
    sj = jsa.init_sparse_colony(inst, cj, None, n_pad)
    st = tsa.init_sparse_colony(inst, ct, None, n_pad, device="cpu")
    for i in range(3):
        sj, bj = jsa.sparse_colony_step(pj, sj, cj, "RAW")
        st, bt = tsa.sparse_colony_step(pt, st, ct, "RAW")
        assert_bitwise(bj, bt, f"step {i} it_best")
        _assert_state(sj, st, f"step {i}")


@pytest.mark.parametrize("window,exact", [(40, True), (20, False)])
def test_partial_aco_window_sums(window, exact):
    """Wide windows sum the replaced and new edges in XLA's 32-wide tree
    order (bitwise); at 13 <= window+1 <= 32 XLA vectorises the fused sum
    of the replaced edges in an order the port does not reproduce, so the
    delta lengths (and AS's deposits) are ulp-close.  Tours and the
    re-measured best stay bitwise."""
    inst = jtsp.random_instance(60, seed=1)
    kw = dict(variant="as", construction="partial", partial_window=window,
              sparse=True, sparse_k=5, m=10, iterations=3, seed=4, rho=0.1,
              use_pallas=True)
    sj, st = _runs(inst, kw)
    _assert_state(sj, st, f"window {window}", tau_exact=exact)


def test_counter_draws_and_gumbel():
    """Counter-mode draws are bitwise; gumbel runs (the ``log`` gap) give
    valid tours no worse than the nearest-neighbour tour."""
    inst = INSTANCES["random"]()
    kw = dict(variant="mmas", draw_mode="counter", sparse=True, sparse_k=6,
              m=10, iterations=3, seed=2, rho=0.1, use_pallas=True)
    _assert_state(*_runs(inst, kw), "counter")
    _, c_nn = tst.sparse_nearest_neighbour_tour(inst)
    for use_pallas in (False, True):
        st = taco.run(inst, taco.ACOConfig(
            variant="mmas", selection="gumbel", sparse=True, sparse_k=6, m=10,
            iterations=3, seed=2, use_pallas=use_pallas), device="cpu")
        assert ttsp.is_valid_tour(st.best_tour.numpy())
        assert float(st.best_len) <= c_nn + 1e-3


def test_aco_run_dispatches_sparse_and_counts_fallbacks():
    """``aco.run(sparse=True)`` is ``run_sparse``; ``walk.fallbacks`` counts
    the (ant, step) pairs whose page was exhausted, which are exactly the
    emitted edges that leave the current city's page."""
    inst = INSTANCES["random"]()
    cfg = taco.ACOConfig(variant="mmas", sparse=True, sparse_k=3,
                         sparse_overflow=0, m=10, iterations=1, seed=1)
    st = taco.run(inst, cfg, device="cpu")
    assert isinstance(st, tst.SparseColonyState)
    for a, b in zip(st, tsa.run_sparse(inst, cfg, device="cpu")):
        assert torch.equal(a, b)
    pt = tst.make_sparse_problem(inst, 3, device="cpu")
    s0 = tsa.init_sparse_colony(inst, cfg, device="cpu")
    tcon.walk.fallbacks = 0
    res = tcon.construct_sparse_tours(s0.key, pt, s0.tau, s0.ovf_city,
                                      s0.ovf_tau, 10, "iroulette", 1.0, 2.0,
                                      "RAW")
    cur, nxt = res.tours[:, :-1].long(), res.tours[:, 1:]
    off_page = ~(pt.cand[cur] == nxt[..., None]).any(-1)
    assert int(tcon.walk.fallbacks) == int(off_page.sum()) > 0


@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_sparse_full_k_equals_dense(variant):
    """At k = n-1 every edge is on a page: the port's sparse route is its
    dense route, tau bitwise for MMAS/ACS and within 2 ulp for AS, which
    is what the reference's own two routes show for AS (41 of 552 cells
    at 2 ulp on circle24, iroulette, both packages)."""
    inst = ttsp.circle_instance(24)
    n = inst.n
    cfg = taco.ACOConfig(iterations=5, m=10, seed=3, variant=variant)
    dense = taco.run(inst, cfg, device="cpu")
    prob = tst.make_sparse_problem(inst, n - 1, device="cpu")
    sparse = tsa.run_sparse(inst, dataclasses.replace(
        cfg, sparse=True, sparse_k=n - 1), problem=prob, device="cpu")
    assert torch.equal(dense.best_tour, sparse.best_tour)
    assert torch.equal(dense.best_len, sparse.best_len)
    rows = torch.arange(n)[:, None]
    ulp = ulp_distance(dense.tau[rows, prob.cand.long()], sparse.tau)
    assert ulp.max() <= (2 if variant == "as" else 0)


def test_convert_carries_sparse_state_both_ways():
    """A quantised reference state into the port, one step on each side,
    and back."""
    inst = INSTANCES["grid"]()
    kw = dict(variant="mmas", tau_dtype="int8", sparse=True, sparse_k=4,
              m=10, seed=6, rho=0.1)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jst.make_sparse_problem(inst, 4)
    pt = convert.sparse_problem_from_numpy(
        **{f: np.asarray(getattr(pj, f))
           for f in ("coords", "cand", "cand_dist", "cand_eta")},
        device="cpu")
    sj, _ = jsa.sparse_colony_step(pj, jsa.init_sparse_colony(inst, cj), cj,
                                   "RAW")
    st = convert.sparse_state_from_numpy(
        *[tuple(np.asarray(y) for y in x) if isinstance(x, tuple)
          else np.asarray(x) for x in sj], device="cpu")
    sj, _ = jsa.sparse_colony_step(pj, sj, cj, "RAW")
    st, _ = tsa.sparse_colony_step(pt, st, ct, "RAW")
    _assert_state(sj, st, "converted")
    back = convert.sparse_state_to_numpy(st)
    assert_bitwise(_bits(sj.ovf_tau.q), back["ovf_tau"][0], "ovf payload")
    assert back["key"].dtype == np.uint32
    assert set(convert.sparse_problem_to_numpy(pt)) == {
        "coords", "cand", "cand_dist", "cand_eta"}


# ------------------------------------------------------- route rejections

REJECTIONS = [
    dict(sparse=True, selection="roulette"),
    dict(sparse=True, local_search="2opt"),
    dict(sparse=True, construction="nn_list"),
    dict(sparse=True, construction="partial", masked=True),
    dict(sparse=True, hyper=True),
    dict(sparse=True, streaming=True),
]


@pytest.mark.parametrize("kw", REJECTIONS)
def test_route_rejections_keep_reference_messages(kw):
    with pytest.raises(jops.UnsupportedKernelRoute) as want:
        jops.check_kernel_route(**kw)
    with pytest.raises(ops.UnsupportedKernelRoute) as got:
        ops.check_kernel_route(**kw)
    assert str(got.value) == str(want.value)
    cfg_kw = {k: v for k, v in kw.items()
              if k in ("selection", "local_search", "construction")}
    if cfg_kw or "masked" in kw or "hyper" in kw:
        extra = {k: kw[k] for k in ("masked", "hyper") if k in kw}
        with pytest.raises(ops.UnsupportedKernelRoute) as got:
            tsa.check_sparse_route(taco.ACOConfig(sparse=True, **cfg_kw),
                                   **extra)
        assert str(got.value) == str(want.value)

