"""The sparse route's instance axis on the CPU.

- ``sparse.aco.sparse_colony_step_batch`` over a (B, n, k) bucket (the
  kernel route: one walk for the stack, the epilogue over (B, ...) pages)
  against ``sparse_colony_step`` per instance: every field of the state,
  the iteration-best lengths and the metrics rows bitwise, AS/MMAS/ACS x
  fp32/int8/bf16 pages x iroulette/gumbel/greedy, with one padded slot and
  one inactive slot that keeps its state.
- A plain emulation of the walk kernel's instance axis (each instance's
  planes at the kernel's offsets into the flat arrays, its ``n_actual``
  from the (B,) array) against ``sparse_walk_plain`` over the stack, which
  walks each slot with ``host_walk``.
- ``engine.run_batch(kind="sparse")`` on the kernel route: one
  ``ops.sparse_walk`` call per engine iteration over the whole stack,
  each slot bitwise its solo run, metrics and ``patience`` included.
- ``engine.solve_instances`` with ``sparse=True`` on the kernel route
  against ``repro.solver.engine.solve_instances`` (its Pallas kernels in
  interpret mode): tours, lengths, iterations, keys, overflow cities and
  pages bitwise, except two reference numerics of ROADMAP queue 3: MMAS
  overflow pages at rtol 1e-5 / atol 1e-7 (the reference's vmapped step
  clamps them one ulp off its own solo step in a padded slot) and ACS over
  int8 pages at rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import engine as jeng  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import quant, tsp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_select as ss  # noqa: E402
from repro_torch.solver import batch, engine  # noqa: E402
from repro_torch.sparse import aco as saco  # noqa: E402
from test_torch_update_walk import walk_emulation  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

N_PAD = 32
NS = (32, 27, 19)                        # exact fit, two padded slots
ACTIVE = (True, False, True)
MODES = ["iroulette", "gumbel", "greedy"]


def _leaves_equal(a, b, what=""):
    for x, y in zip(tree.flatten(a), tree.flatten(b)):
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert_bitwise(x, y, what)


def _bucket(cfg, seeds=(1, 2, 3)):
    insts = [tsp.random_instance(n, seed=n) for n in NS]
    sb = batch.make_sparse_batch(insts, cfg.sparse_k, N_PAD, device="cpu")
    states = engine.init_sparse_states(insts, cfg, list(seeds), N_PAD, "cpu")
    return insts, sb, states


# ----------------------------------------------------- the batched step
@pytest.mark.parametrize("selection", MODES)
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_batched_step_equals_solo_steps(variant, tau_dtype, selection):
    """Three engine iterations of the stack (slot 1 inactive throughout)
    against three solo steps of each active slot: states, iteration-best
    lengths and metrics rows bitwise."""
    cfg = taco.ACOConfig(variant=variant, tau_dtype=tau_dtype,
                         selection=selection, sparse=True, sparse_k=5,
                         sparse_overflow=2, m=8, rho=0.1, use_pallas=True,
                         metrics=True)
    _, sb, states = _bucket(cfg)
    prob = sb.problem
    solo = [tree.index(states, b) for b in range(len(NS))]
    adopted = 0
    for it in range(3):
        new, it_best, mets = saco.sparse_colony_step_batch(
            prob, states, cfg, sb.ewt, active=ACTIVE)
        for b in range(len(NS)):
            if not ACTIVE[b]:
                continue
            s1, best1, met1 = saco.sparse_colony_step(
                prob.slot(b, NS[b]), solo[b], cfg, sb.ewt)
            what = f"{variant} {tau_dtype} {selection} step {it} slot {b}"
            _leaves_equal(tree.index(new, b), s1, what)
            assert_bitwise(it_best[b], best1, what)
            _leaves_equal(tree.index(mets, b), met1, what + " metrics")
            solo[b] = s1
            adopted += int(met1.ovf_adopted)
        # the engine's write-back: an inactive slot keeps its state
        states = tree.map(lambda nw, od: torch.stack(
            [nw[b] if ACTIVE[b] else od[b] for b in range(len(NS))]),
            new, states)
    assert states.iteration.tolist() == [3, 0, 3]
    if variant != "as":
        assert adopted > 0                    # the overflow pages are used


def test_batched_step_rejects_other_routes_and_bad_counts():
    cfg = taco.ACOConfig(variant="mmas", sparse=True, sparse_k=5, m=8)
    _, sb, states = _bucket(cfg)
    with pytest.raises(ValueError, match="kernel route"):
        saco.sparse_colony_step_batch(sb.problem, states, cfg, sb.ewt)
    kcfg = taco.ACOConfig(variant="mmas", sparse=True, sparse_k=5, m=8,
                          use_pallas=True)
    bad = sb.problem._replace(n_actual=(32, 40, 19))
    with pytest.raises(ValueError, match="n_actual"):
        saco.sparse_colony_step_batch(bad, states, kcfg, sb.ewt)
    assert saco.batched_route(kcfg) and not saco.batched_route(cfg)
    assert not saco.batched_route(taco.ACOConfig(
        sparse=True, use_pallas=True, construction="partial"))


# ------------------------------------------- the kernel's instance axis
def kernel_index_emulation(problem, tau, ovf_city, ovf_tau, start, visited,
                           keys, selection, ewt, draw_mode, n_actual,
                           active):
    """The walk kernel's instance axis in plain torch: instance b reads its
    planes at the kernel's offsets into the flat arrays (coordinates b n
    pairs, pages b n k, overflow pages b n O, int8 row scales b n, start
    b m, tabu row of ant a (b m + a) n, keys b S 2) and writes its outputs
    at b S m + s m + a and b m + a; ``n_actual[b]`` bounds the fallback
    and starts the phantom tail; an inactive instance is skipped."""
    nb, n, k = problem.cand.shape
    o, m, steps = ovf_city.shape[-1], start.shape[-1], keys.shape[-2]
    q, scale = ss._payload(tau)
    oq, oscale = ss._payload(ovf_tau)
    flat = [x.reshape(-1) for x in (*problem[:4], q, ovf_city, oq, start,
                                    visited, keys)]
    coords, cand, cdist, ceta, qf, ocf, oqf, stf, visf, keyf = flat
    out_city = torch.zeros(nb * steps * m, dtype=torch.int32)
    out_dist = torch.zeros(nb * steps * m, dtype=torch.float32)
    fallbacks = torch.zeros(nb * m, dtype=torch.int32)

    def plane(x, base, shape):
        size = int(np.prod(shape))
        return x[base:base + size].view(shape)

    for b in range(nb):
        if not active[b]:
            continue
        nk, no = b * n * k, b * n * o
        prob_b = problem._replace(
            coords=plane(coords, 2 * b * n, (n, 2)),
            cand=plane(cand, nk, (n, k)), cand_dist=plane(cdist, nk, (n, k)),
            cand_eta=plane(ceta, nk, (n, k)), n_actual=None)
        tau_b = plane(qf, nk, (n, k))
        ovf_b = plane(oqf, no, (n, o))
        if scale is not None:
            tau_b = quant.QuantTau(tau_b, plane(scale.reshape(-1), b * n,
                                                (n, 1)), tau.err[b])
            ovf_b = quant.QuantTau(ovf_b, plane(oscale.reshape(-1), b * n,
                                                (n, 1)), ovf_tau.err[b])
        n_act = int(n_actual[b])
        cities, dists, fb = walk_emulation(
            prob_b, tau_b, plane(ocf, no, (n, o)), ovf_b,
            plane(stf, b * m, (m,)), plane(visf, b * m * n, (m, n)),
            plane(keyf, b * steps * 2, (steps, 2)), selection, ewt,
            draw_mode, n_act)
        plane(out_city, b * steps * m, (steps, m)).copy_(cities)
        plane(out_dist, b * steps * m, (steps, m)).copy_(dists)
        plane(fallbacks, b * m, (m,)).copy_(fb)
    return (out_city.view(nb, steps, m), out_dist.view(nb, steps, m),
            fallbacks.view(nb, m))


@pytest.mark.parametrize("tau_dtype,selection,draw_mode", [
    ("fp32", "iroulette", "packed"), ("int8", "gumbel", "counter"),
    ("bf16", "greedy", "packed"), ("int8", "iroulette", "packed")])
def test_kernel_instance_indexing_is_the_plain_stack(tau_dtype, selection,
                                                     draw_mode):
    """The stack's plain walk (``host_walk`` per slot on its views) equals
    the kernel's flat indexing, emulated: cities, lengths, fallback counts
    and the tabu rows, the inactive slot untouched."""
    operands = ss.stack_walk_operands((40, 33, 25, 37), 40, 6, 4, 3,
                                      tau_dtype, torch.device("cpu"), seed=7)
    problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
    n_act = torch.tensor(problem.n_actual, dtype=torch.int32)
    active = (True, True, False, True)
    vis_p, vis_e = visited.clone(), visited.clone()
    want = ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau, start,
                                vis_p, keys, selection, 1.0, 2.0, "EUC_2D",
                                draw_mode, n_act, active)
    got = kernel_index_emulation(problem, tau, ovf_city, ovf_tau, start,
                                 vis_e, keys, selection, "EUC_2D", draw_mode,
                                 n_act, active)
    for g, w, what in zip(got, want, ("cities", "lengths", "fallbacks")):
        assert_bitwise(w, g, what)
    assert torch.equal(vis_p, vis_e)
    assert torch.equal(vis_p[2], visited[2]) and not want[0][2].any()
    assert int(want[2].sum()) > 0            # the page-fault path is taken
    # each slot is its own single walk
    for b in (0, 3):
        vis_1 = visited[b].clone()
        one = ss.sparse_walk_plain(
            problem.slot(b, problem.n_actual[b]), tree.index(tau, b),
            ovf_city[b], tree.index(ovf_tau, b), start[b], vis_1, keys[b],
            selection, 1.0, 2.0, "EUC_2D", draw_mode, problem.n_actual[b])
        for g, w in zip(one, want):
            assert_bitwise(w[b], g, f"slot {b}")


# ---------------------------------------------------------- the engine
@pytest.mark.parametrize("kw", [
    dict(variant="mmas", metrics=True),
    dict(variant="acs", tau_dtype="int8"),
    dict(variant="as", selection="gumbel", draw_mode="counter"),
])
def test_run_batch_walks_the_stack_once_per_engine_iteration(kw,
                                                             monkeypatch):
    calls = []
    inner = ops.sparse_walk

    def counting(problem, *args, **kwargs):
        calls.append(problem.cand.shape[0])
        return inner(problem, *args, **kwargs)

    monkeypatch.setattr(ops, "sparse_walk", counting)
    cfg = taco.ACOConfig(sparse=True, sparse_k=5, sparse_overflow=2, m=8,
                         rho=0.1, use_pallas=True, iterations=5, **kw)
    insts = [tsp.random_instance(n, seed=n) for n in NS]
    budgets = [5, 3, 4]
    st, sb = engine.solve_instances(insts, cfg, iterations=budgets,
                                    seeds=[1, 2, 3], device="cpu")
    assert calls == [3] * 5                  # one walk per engine iteration
    assert st.iteration.tolist() == budgets
    for b, inst in enumerate(insts):
        calls.clear()
        one, _ = engine.solve_instances([inst], cfg, iterations=[budgets[b]],
                                        seeds=[b + 1], n_pad=N_PAD,
                                        device="cpu")
        assert calls == [1] * budgets[b]
        _leaves_equal(tree.index(st, b), tree.index(one, 0), f"slot {b}")
    for r, inst in zip(engine.collect(st, sb), insts):
        assert tsp.is_valid_tour(r["best_tour"]) and r["n"] == inst.n


def test_run_batch_sparse_patience_chunks_and_metrics():
    """``patience`` freezes stalled slots on the stacked route, chunked
    calls compose with one long call, and the metrics rows freeze with
    their slots."""
    cfg = taco.ACOConfig(variant="mmas", sparse=True, sparse_k=5, m=8,
                         use_pallas=True, metrics=True, selection="greedy")
    _, sb, init = _bucket(cfg)
    long = engine.run_batch(sb.problem, init, [9, 7, 8], cfg, 9, patience=2,
                            kind="sparse", ewt=sb.ewt)
    carry = (init, None, None)
    for _ in range(5):
        carry = engine.run_batch(sb.problem, carry[0], [9, 7, 8], cfg, 2,
                                 patience=2, since=carry[1], mets=carry[2],
                                 kind="sparse", ewt=sb.ewt)
    _leaves_equal(long, carry, "chunked")
    assert max(long[0].iteration.tolist()) < 9     # greedy stalls early
    assert int(init.iteration.max()) == 0          # inputs untouched


# ---------------------------------------------------- the reference
@pytest.mark.parametrize("kw,loose", [
    # the reference's vmapped MMAS step bounds the overflow pages' clamp
    # one ulp off its solo step's in a padded slot (ROADMAP queue 3);
    # the port's batched and solo steps both give the solo numbers
    (dict(variant="mmas"), dict(ovf_tau=dict(rtol=1e-5, atol=1e-7))),
    (dict(variant="as", selection="greedy"), {}),
    # ACS over a quantised sparse store (ROADMAP queue 3)
    (dict(variant="acs", tau_dtype="int8"),
     dict(tau=dict(rtol=1e-4, atol=1e-6))),
])
def test_solve_instances_sparse_kernel_route_equals_reference(kw, loose):
    kw = dict(sparse=True, sparse_k=5, sparse_overflow=2, m=8, rho=0.1,
              use_pallas=True, iterations=4, **kw)
    insts = [jtsp.random_instance(n, seed=n) for n in NS]
    budgets, seeds = [4, 2, 3], [1, 2, 3]
    sj, _ = jeng.solve_instances(insts, jaco.ACOConfig(**kw),
                                 iterations=budgets, seeds=seeds)
    st, sb = engine.solve_instances(insts, taco.ACOConfig(**kw),
                                    iterations=budgets, seeds=seeds,
                                    device="cpu")
    assert sb.n_pad == N_PAD
    got = convert.states_to_numpy(st)
    for f in ("best_tour", "best_len", "iteration"):
        assert_bitwise(getattr(sj, f), got[f], f)
    assert_bitwise(np.asarray(sj.key).astype(np.uint32), got["key"], "key")
    assert_bitwise(sj.ovf_city, got["ovf_city"], "ovf_city")
    for f in ("tau", "tau_def", "ovf_tau"):
        ref, port = getattr(sj, f), got[f]
        for a, b in zip(ref if isinstance(ref, tuple) else (ref,),
                        port if isinstance(port, tuple) else (port,)):
            a = np.asarray(a)
            if str(a.dtype) == "bfloat16":
                a = a.view(np.int16)
            if f in loose and a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, **loose[f], err_msg=f)
            else:
                assert_bitwise(a, b, f)
