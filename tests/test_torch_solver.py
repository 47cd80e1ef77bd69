"""Port parity for the batched solver: repro_torch.solver against repro.solver.

The port's engine steps the whole stack at once on the dense kernel
routes (fused or ``pallas`` construction, with or without local search)
and is a host loop of single-instance colony steps over the slots of a
stacked state elsewhere; the reference's is one jitted ``while_loop`` of
the vmapped step.  Held against ``repro.solver.engine`` directly, on the
four instances of tests/test_solver.py in bucket 16 (every slot masked):

- tours, best lengths, iterations and keys bitwise in every case;
- tau bitwise, except: ACS on the pure route, where XLA fuses the vmapped
  local rule as ``fma(1 - f, tau0, f * tau)`` and its solo step (which the
  port follows) as ``fma(f, tau, (1 - f) * tau0)``, and AS/ACS on the
  kernel route at rho != 0.5, where the reference's one-step Pallas update
  fuses evaporation into the deposit (ROADMAP queue 3).  There tau is held
  at rtol 1e-5 / atol 1e-7.
- batched == solo bitwise in the port, every field, gumbel included, and
  a chunked run bitwise the one long run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import batch as jbatch  # noqa: E402
from repro.solver import engine as jeng  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.solver import batch as tbatch  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

INSTS = (jtsp.random_instance(10, seed=1), jtsp.circle_instance(12, seed=2),
         jtsp.random_instance(13, seed=3), jtsp.circle_instance(16, seed=4))
SEEDS = (5, 6, 7, 8)
BUDGETS = (6, 5, 6, 4)
TOL = dict(rtol=1e-5, atol=1e-7)


def _tau_leaves(tau):
    return tau if isinstance(tau, tuple) else (tau,)


def assert_states(sj, st, tau_exact=True, what=""):
    """A reference state stack against the port's: every field bitwise, tau
    (each quantised leaf) bitwise or at TOL."""
    got = convert.states_to_numpy(st)
    for f in ("best_tour", "best_len", "iteration"):
        assert_bitwise(getattr(sj, f), got[f], f"{what} {f}")
    assert_bitwise(np.asarray(sj.key).astype(np.uint32), got["key"],
                   f"{what} key")
    fields = ["tau"] + (["tau_def", "ovf_city", "ovf_tau"]
                        if "tau_def" in got else [])
    for f in fields:
        for a, b in zip(_tau_leaves(getattr(sj, f)), _tau_leaves(got[f])):
            a = np.asarray(a)
            if str(a.dtype) == "bfloat16":       # raw bits, as the port's
                a = a.view(np.int16)
            if tau_exact or a.dtype.kind != "f":
                assert_bitwise(a, b, f"{what} {f}")
            else:
                np.testing.assert_allclose(a, b, **TOL)


def _both(kw, budgets=BUDGETS, hypers=None, **call):
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    hj = ht = None
    if hypers is not None:
        hj = [jaco.Hyper.make(cj, **h) for h in hypers]
        ht = [taco.Hyper.make(ct, device="cpu", **h) for h in hypers]
    sj, _ = jeng.solve_instances(INSTS, cj, iterations=budgets, seeds=SEEDS,
                                 n_pad=16, hypers=hj, **call)
    st, tb = teng.solve_instances(INSTS, ct, iterations=budgets,
                                  seeds=SEEDS, n_pad=16, hypers=ht,
                                  device="cpu", **call)
    return sj, st, tb


# ------------------------------------------------------------- batching
def test_bucket_helpers_equal_reference():
    for n in (1, 3, 15, 16, 17, 100, 613, 1024, 1025, 2000):
        for mb in (4, 16):
            assert tbatch.bucket_size(n, mb) == jbatch.bucket_size(n, mb)
    for lo, hi in ((3, 3), (10, 100), (613, 2000), (16, 16)):
        assert tbatch.bucket_ladder(lo, hi) == jbatch.bucket_ladder(lo, hi)
    sizes = [10, 12, 14, 20, 24, 30, 100]
    assert tbatch.group_by_bucket(sizes) == jbatch.group_by_bucket(sizes)
    tour = np.arange(16)[::-1].copy()
    assert_bitwise(jbatch.trim_tour(tour, 10),
                   tbatch.trim_tour(torch.from_numpy(tour), 10))
    for mod in (tbatch, jbatch):
        with pytest.raises(ValueError):
            mod.bucket_size(0)
        with pytest.raises(ValueError):
            mod.bucket_ladder(5, 4)


@pytest.mark.parametrize("n", [10, 16])
def test_padded_problem_equals_reference(n):
    """Phantom rows at inf distance, eta exactly 0, the reference's NN
    lists; n_actual set even for an exact fit."""
    inst = jtsp.random_instance(n, seed=0)
    pj = jbatch.padded_problem(inst, 16, nn_k=8)
    pt = tbatch.padded_problem(inst, 16, nn_k=8, device="cpu")
    for f in ("dist", "eta", "nn"):
        assert_bitwise(getattr(pj, f), getattr(pt, f), f)
    assert pt.n_actual == int(pj.n_actual) == n
    assert (pt.eta[n:, :n] == 0).all() and (pt.eta[:n, n:] == 0).all()


def test_make_batch_equals_reference():
    bj = jbatch.make_batch(INSTS, nn_k=8)
    bt = tbatch.make_batch(INSTS, nn_k=8, device="cpu")
    assert bt.n_pad == bj.n_pad == 16 and bt.size == 4
    for f in ("dist", "eta", "nn"):
        assert_bitwise(getattr(bj.problem, f), getattr(bt.problem, f), f)
    assert bt.problem.n_actual == tuple(np.asarray(bj.problem.n_actual))
    back = convert.problem_batch_from_numpy(
        bj.problem.dist, bj.problem.eta, bj.problem.nn,
        bj.problem.n_actual, device="cpu")
    for f in ("dist", "eta", "nn", "n_actual"):
        assert_bitwise(np.asarray(getattr(back, f)),
                       np.asarray(getattr(bt.problem, f)), f)
    slot = tbatch.slot_problem(bt.problem, 2)
    assert slot.n_actual == 13 and slot.dist.shape == (16, 16)
    assert slot.dist.data_ptr() == bt.problem.dist[2].data_ptr()   # a view


def test_batch_rejections_keep_reference_messages():
    cj, ct = jaco.ACOConfig(), taco.ACOConfig()
    with pytest.raises(ValueError, match="all-None or all-set") as want:
        jbatch.make_batch(INSTS[:2], 16, hypers=[jaco.Hyper.make(cj), None])
    with pytest.raises(ValueError) as got:
        tbatch.make_batch(INSTS[:2], 16, device="cpu",
                          hypers=[taco.Hyper.make(ct, device="cpu"), None])
    assert str(got.value) == str(want.value)
    mixed = [jtsp.random_instance(10, seed=0),
             jtsp.TSPInstance(name="geo", coords=np.zeros((10, 2)),
                              edge_weight_type="GEO")]
    with pytest.raises(ValueError) as want:
        jbatch.make_sparse_batch(mixed, 4)
    with pytest.raises(ValueError) as got:
        tbatch.make_sparse_batch(mixed, 4, device="cpu")
    assert str(got.value) == str(want.value)
    for mod, kw in ((jbatch, {}), (tbatch, {"device": "cpu"})):
        with pytest.raises(ValueError, match="empty batch"):
            mod.make_batch([], **kw)


def test_make_sparse_batch_equals_reference():
    insts = [jtsp.random_instance(n, seed=n) for n in (20, 25, 32)]
    bj = jbatch.make_sparse_batch(insts, 6)
    bt = tbatch.make_sparse_batch(insts, 6, device="cpu")
    assert (bt.n_pad, bt.k, bt.ewt) == (bj.n_pad, bj.k, bj.ewt) == \
        (32, 6, insts[0].edge_weight_type)
    for f in ("coords", "cand", "cand_dist", "cand_eta"):
        assert_bitwise(getattr(bj.problem, f), getattr(bt.problem, f), f)
    assert bt.problem.n_actual == (20, 25, 32)      # exact fit set too


# --------------------------------------------------- engine vs reference


def test_chunked_calls_compose_with_one_long_call():
    """budgets are absolute and ``since`` travels between chunks: chunks
    of 2 equal one long call (port) and the reference's long call, with
    patience and metrics rows."""
    kw = dict(variant="mmas", iterations=9, metrics=True)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    budgets = [9, 7, 9, 5]
    bj = jbatch.make_batch(INSTS, 16, cj.nn_k)
    ref = jeng.run_batch(bj.problem, jeng.init_states(INSTS, cj, SEEDS, 16),
                         jnp.asarray(budgets, jnp.int32), cj, 9, patience=3)
    bt = tbatch.make_batch(INSTS, 16, ct.nn_k, device="cpu")
    init = teng.init_states(INSTS, ct, SEEDS, 16, device="cpu")
    long = teng.run_batch(bt.problem, init, budgets, ct, 9, patience=3)
    carry = (init, None, None)
    for _ in range(5):
        carry = teng.run_batch(bt.problem, carry[0], budgets, ct, 2,
                               patience=3, since=carry[1], mets=carry[2])
    for a, b in zip(tree.flatten(long), tree.flatten(carry)):
        assert_bitwise(a, b, "chunked")
    assert_states(ref[0], long[0])
    assert_bitwise(ref[1], long[1], "since")
    for f, v in convert.metrics_to_numpy(long[2]).items():
        if f in ("mean_len", "tau_mean"):       # XLA's sum order
            np.testing.assert_allclose(np.asarray(getattr(ref[2], f)), v,
                                       **TOL)
        else:
            assert_bitwise(getattr(ref[2], f), v, f)
    # the inputs are untouched without donate
    assert int(init.iteration.max()) == 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_reference_stack_carried_across_continues_bitwise(kind):
    """The reference's batch and its state stack after two engine
    iterations, carried into the port (``convert``), continue to the
    reference's state after five: dense with Hyper profiles, sparse with
    int8 pages and overflow slots."""
    if kind == "dense":
        kw = dict(variant="mmas", iterations=5, selection="gumbel")
        insts = INSTS
        cj = jaco.ACOConfig(**kw)
        hj = [jaco.Hyper.make(cj, rho=r) for r in (0.2, 0.5, 0.3, 0.7)]
        bj = jbatch.make_batch(insts, 16, cj.nn_k, hypers=hj)
        init = jeng.init_states(insts, cj, SEEDS, 16, hj)
        prob = bj.problem
        pt = convert.problem_batch_from_numpy(
            prob.dist, prob.eta, prob.nn, prob.n_actual,
            hyper=tuple(prob.hyper), device="cpu")
        call = {}
    else:
        kw = dict(variant="mmas", sparse=True, sparse_k=5,
                  sparse_overflow=2, m=8, iterations=5, tau_dtype="int8")
        insts = [jtsp.random_instance(n, seed=n) for n in (20, 25, 30)]
        cj = jaco.ACOConfig(**kw)
        bj = jbatch.make_sparse_batch(insts, cj.sparse_k)
        init = jeng.init_sparse_states(insts, cj, [1, 2, 3], bj.n_pad)
        prob = bj.problem
        pt = convert.sparse_problem_from_numpy(
            prob.coords, prob.cand, prob.cand_dist, prob.cand_eta,
            device="cpu")._replace(n_actual=tuple(
                int(x) for x in np.asarray(prob.n_actual)))
        call = dict(kind="sparse", ewt=bj.ewt)
    budgets = jnp.full((len(insts),), 5, jnp.int32)
    mid = jeng.run_batch(prob, init, budgets, cj, 2, **call)[0]
    want = jeng.run_batch(prob, mid, budgets, cj, 3, **call)[0]

    def fields(st):
        out = {}
        for f, v in st._asdict().items():
            out[f] = tuple(np.asarray(x) for x in v) \
                if isinstance(v, tuple) else np.asarray(v)
        return out

    st = convert.states_from_numpy(device="cpu", **fields(mid))
    got = teng.run_batch(pt, st, [5] * len(insts), taco.ACOConfig(**kw), 3,
                         **call)[0]
    assert_states(want, got)


def test_sparse_bucket_equals_reference():
    """A sparse (n_pad, k) bucket: pages, overflow slots and tours bitwise,
    masked slots, mixed budgets."""
    insts = [jtsp.random_instance(n, seed=n) for n in (20, 25, 30)]
    kw = dict(variant="mmas", sparse=True, sparse_k=6, sparse_overflow=2,
              m=8, iterations=5)
    sj, _ = jeng.solve_instances(insts, jaco.ACOConfig(**kw),
                                 iterations=[5, 3, 4], seeds=[1, 2, 3])
    st, sb = teng.solve_instances(insts, taco.ACOConfig(**kw),
                                  iterations=[5, 3, 4], seeds=[1, 2, 3],
                                  device="cpu")
    assert sb.n_pad == 32 and sb.k == 6
    assert_states(sj, st)
    rows = teng.collect(st, sb)
    for r, inst in zip(rows, insts):
        assert ttsp.is_valid_tour(r["best_tour"]) and r["n"] == inst.n


# ------------------------------------------------ the port's own contracts
@pytest.mark.parametrize("kw", [
    dict(variant="as", selection="gumbel"),
    dict(variant="mmas", local_search="2opt_oropt", ls_rounds=4,
         selection="gumbel"),
    dict(variant="acs", local_search="2opt", ls_rounds=4),
    dict(variant="mmas", use_pallas=True, tau_dtype="int8"),
])
def test_batched_equals_solo_bitwise(kw):
    """An instance solved inside a padded batch is, field for field, the
    same instance solved alone in the same bucket with the same seed."""
    cfg = taco.ACOConfig(iterations=max(BUDGETS), **kw)
    stb, b = teng.solve_instances(INSTS, cfg, iterations=BUDGETS,
                                  seeds=SEEDS, n_pad=16, device="cpu")
    assert stb.iteration.tolist() == list(BUDGETS)
    for i, inst in enumerate(INSTS):
        st1, _ = teng.solve_instances([inst], cfg, iterations=[BUDGETS[i]],
                                      seeds=[SEEDS[i]], n_pad=16,
                                      device="cpu")
        for a, c in zip(tree.flatten(tree.index(stb, i)),
                        tree.flatten(tree.index(st1, 0))):
            assert_bitwise(a, c, f"slot {i}")
        row = teng.collect(stb, b)[i]
        real = row["best_tour"]
        assert ttsp.is_valid_tour(real) and len(real) == inst.n
        d = inst.distances()
        np.testing.assert_allclose(row["best_len"],
                                   d[real, np.roll(real, -1)].sum(),
                                   rtol=1e-5)


def test_engine_anchor_exact_when_unpadded():
    """n_actual == n_pad: the mask-aware engine reduces to aco.run."""
    inst = ttsp.circle_instance(16, seed=3)
    cfg = taco.ACOConfig(iterations=6, seed=11, variant="mmas")
    plain = taco.run(inst, cfg, device="cpu")
    states, _ = teng.solve_instances([inst], cfg, seeds=[cfg.seed],
                                     n_pad=16, device="cpu")
    for f in ("tau", "best_tour", "best_len", "iteration", "key"):
        assert_bitwise(getattr(plain, f), getattr(states, f)[0], f)


def test_donate_updates_in_place_with_the_same_result():
    cfg = taco.ACOConfig(iterations=4, variant="mmas")
    b = tbatch.make_batch(INSTS, 16, device="cpu")
    s_a = teng.init_states(INSTS, cfg, SEEDS, 16, device="cpu")
    s_b = tree.map(torch.clone, s_a)
    out_a = teng.run_batch(b.problem, s_a, [4, 2, 3, 1], cfg, 4)
    out_b = teng.run_batch(b.problem, s_b, [4, 2, 3, 1], cfg, 4,
                           donate=True)
    assert out_b[0].tau is s_b.tau                  # the same storage
    for a, c in zip(tree.flatten(out_a), tree.flatten(out_b)):
        assert_bitwise(a, c, "donate")


def test_engine_rejections():
    cfg = taco.ACOConfig(iterations=2)
    mesh = Mesh([torch.device("cpu")] * 2, ("data",))
    # a sparse bucket over a mesh: the reference's message
    scfg = dict(sparse=True, sparse_k=6, iterations=2)
    with pytest.raises(Exception) as want:
        jeng.solve_instances(INSTS, jaco.ACOConfig(**scfg), mesh=object())
    with pytest.raises(tops.UnsupportedKernelRoute) as got:
        teng.solve_instances(INSTS, taco.ACOConfig(**scfg), mesh=mesh,
                             device="cpu")
    assert str(got.value) == str(want.value)
    b = tbatch.make_batch(INSTS, 16, device="cpu")
    st = teng.init_states(INSTS, cfg, SEEDS, 16, device="cpu")
    # an attached cache without the call's signature: a miss, the
    # engine's own path
    from repro_torch.solver.programs import ProgramCache
    pc = ProgramCache()
    for x, y in zip(tree.flatten(teng.run_batch(b.problem, st, BUDGETS, cfg,
                                                2, programs=pc)),
                    tree.flatten(teng.run_batch(b.problem, st, BUDGETS, cfg,
                                                2))):
        assert_bitwise(x, y, "miss")
    assert pc.stats()["misses"] == 1 and pc.stats()["hits"] == 0
    with pytest.raises(ValueError, match="no axis"):
        teng.run_batch(b.problem, st, BUDGETS, cfg, 2, mesh=mesh,
                       instance_spec="model")
    with pytest.raises(ValueError, match="budgets"):
        teng.run_batch(b.problem, st, BUDGETS[:2], cfg, 2)
    # the kernel route rejects a Hyper with the reference's message
    hb = tbatch.make_batch(INSTS, 16, device="cpu", hypers=[
        taco.Hyper.make(cfg, device="cpu") for _ in INSTS])
    with pytest.raises(tops.UnsupportedKernelRoute, match="use_pallas"):
        teng.run_batch(hb.problem, st, BUDGETS,
                       taco.ACOConfig(use_pallas=True), 2)
    # a slot view off a 16-byte boundary is refused, never copied
    odd = tbatch.make_batch(INSTS[:2], 17, device="cpu")
    ost = teng.init_states(INSTS[:2], cfg, SEEDS[:2], 17, device="cpu")
    with pytest.raises(ValueError, match="16-byte"):
        teng.run_batch(odd.problem, ost, [1, 1],
                       taco.ACOConfig(use_pallas=True), 1)
    # sparse Partial-ACO on masked slots: the reference's message
    kw = dict(sparse=True, construction="partial", sparse_k=4, m=4)
    with pytest.raises(tops.UnsupportedKernelRoute) as got:
        teng.solve_instances(INSTS, taco.ACOConfig(**kw), device="cpu")
    with pytest.raises(Exception) as want:
        jeng.solve_instances(INSTS, jaco.ACOConfig(**kw))
    assert str(got.value) == str(want.value)


def test_entry_points_need_an_explicit_cpu():
    cfg = taco.ACOConfig(iterations=1)
    if torch.cuda.is_available():
        assert teng.init_states(INSTS[:1], cfg, [0], 16).tau.is_cuda
        return
    for call in (lambda: teng.solve_instances(INSTS, cfg),
                 lambda: teng.init_states(INSTS, cfg, SEEDS, 16),
                 lambda: tbatch.make_batch(INSTS),
                 lambda: taco.Hyper.make(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("kw", [dict(variant="mmas"),
                                dict(variant="acs", use_pallas=True,
                                     metrics=True)])
def test_run_batch_through_a_warmed_program(kw):
    """``run_batch(programs=)`` on a warmed signature (``aot_lower``'s
    program) is a hit and bitwise the plain call and the reference's
    ``run_batch``, in place and not."""
    from repro_torch.solver.programs import ProgramCache
    cfg = taco.ACOConfig(iterations=4, **kw)
    b = tbatch.make_batch(INSTS, 16, device="cpu")
    pc = ProgramCache()
    for donate in (False, True):
        pc.warm([16], len(INSTS), cfg, 4, donate=donate, device="cpu")
    jb = jbatch.make_batch(INSTS, 16)
    jst = jeng.init_states(INSTS, jaco.ACOConfig(iterations=4, **kw), SEEDS,
                           16)
    want = jeng.run_batch(jb.problem, jst, jnp.asarray(BUDGETS, jnp.int32),
                          jaco.ACOConfig(iterations=4, **kw), 4)
    for donate in (False, True):
        st = teng.init_states(INSTS, cfg, SEEDS, 16, device="cpu")
        got = teng.run_batch(b.problem, st, BUDGETS, cfg, 4, donate=donate,
                             programs=pc)
        plain = teng.run_batch(b.problem, teng.init_states(
            INSTS, cfg, SEEDS, 16, device="cpu"), BUDGETS, cfg, 4)
        for x, y in zip(tree.flatten(plain), tree.flatten(got)):
            assert_bitwise(x, y, "program")
        assert_bitwise(np.asarray(want[0].best_len), got[0].best_len,
                       "best_len")
        assert_bitwise(np.asarray(want[0].best_tour), got[0].best_tour,
                       "best_tour")
    assert pc.stats()["hits"] == 2 and pc.stats()["misses"] == 0
