"""Port parity for the program cache through the services
(``repro_torch.solver.programs`` with ``SolverService`` /
``StreamingSolverService``), the counterparts of tests/test_programs.py's
service tests on the CPU:

- a warmed drain or stream returns bitwise what the plain one returns (and
  the reference's plain run), with the reference's hit/miss accounting;
  phantom padding to ``max_batch`` is exact; a background warm lands and a
  cold bucket misses and still solves;
- a neighbour-routed request (AS, MMAS, ACS, int8, sparse, the kernel
  route) is bitwise its native route in the port, its tour and length
  bitwise the reference's native run, and the routed engine run's tau
  the reference's native tau within the DESIGN.md section 10 contract
  (rtol 1e-5 / atol 1e-7 on the real block); packed draws never route;
- counter draws are width-invariant and packed draws width-dependent.

The reference runs only its plain services here: its AOT warmup stays out
of long-lived test processes (tests/test_programs.py isolates it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import engine as jeng  # noqa: E402
from repro.solver import service as jsvc  # noqa: E402
from repro.solver import streaming as jstream  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import programs as tprog  # noqa: E402
from repro_torch.solver import service as tsvc  # noqa: E402
from repro_torch.solver import streaming as tstream  # noqa: E402
from test_torch_programs import TOL, _counter, _drain, _same  # noqa: E402
from torch_parity import assert_bitwise, to_np  # noqa: E402


WARM_INSTS = ((10, 1, "random"), (12, 2, "circle"), (14, 3, "random"))


def _insts(mod, specs):
    return [getattr(mod, f"{kind}_instance")(n, seed=seed)
            for n, seed, kind in specs]


@pytest.mark.parametrize("kw", [dict(), dict(use_pallas=True)])
def test_warm_hit_is_bitwise_plain_path(kw):
    """A warmed drain service returns bitwise what the plain service
    returns (and, on the pure route, what the reference's returns), every
    job a hit and no miss."""
    base = dict(iterations=4, variant="mmas", seed=0, **kw)
    seeds = [50, 51, 52]
    plain = tsvc.SolverService(taco.ACOConfig(**base), max_batch=2,
                               device="cpu")
    want = _drain(plain, _insts(ttsp, WARM_INSTS), seeds)
    pc = tprog.ProgramCache()
    svc = tsvc.SolverService(taco.ACOConfig(**base), max_batch=2,
                             programs=pc, device="cpu")
    summary = svc.warm_programs(10, 14)
    assert set(summary["buckets"]) == {"16"} and not summary["errors"]
    got = _drain(svc, _insts(ttsp, WARM_INSTS), seeds)
    st = svc.stats["programs"]
    assert st["hits"] == 2 and st["misses"] == 0
    assert st["warmup_programs"] == 1 and st["warmup_compile_s"] > 0
    assert pc.warmed_buckets("dense") == (16,)
    assert st["signatures"][0]["eager"] and st["signatures"][0]["graphs"] == 0
    _same(want, got)
    if not kw:
        ref = _drain(jsvc.SolverService(jaco.ACOConfig(**base), max_batch=2),
                     _insts(jtsp, WARM_INSTS), seeds)
        _same(ref, got)


def test_drain_phantom_padding_is_exact():
    """One real request padded with budget-0 phantom slots to max_batch
    surfaces exactly the solo result, and only that result."""
    base = dict(iterations=4, seed=0)
    plain = tsvc.SolverService(taco.ACOConfig(**base), max_batch=4,
                               device="cpu")
    want = _drain(plain, [ttsp.random_instance(11, seed=7)], [9])
    pc = tprog.ProgramCache()
    svc = tsvc.SolverService(taco.ACOConfig(**base), max_batch=4,
                             programs=pc, device="cpu")
    svc.warm_programs(11, 11)
    got = _drain(svc, [ttsp.random_instance(11, seed=7)], [9])
    assert len(got) == len(want) == 1
    assert svc.stats["programs"]["hits"] == 1
    _same(want, got)
    ref = _drain(jsvc.SolverService(jaco.ACOConfig(**base), max_batch=4),
                 [jtsp.random_instance(11, seed=7)], [9])
    _same(ref, got)
    assert ttsp.is_valid_tour(got[0].best_tour)


def test_background_warm_and_miss_fallback():
    """A background warm lands (``wait``) and the next call hits; an
    unwarmed bucket misses and still solves."""
    pc = tprog.ProgramCache()
    svc = tsvc.SolverService(taco.ACOConfig(iterations=3, seed=0),
                             max_batch=2, programs=pc, device="cpu")
    t = svc.warm_programs(10, 10, background=True)
    assert t is not None
    pc.wait()
    assert pc.warmed_buckets("dense") == (16,)
    got = _drain(svc, [ttsp.random_instance(10, seed=4)], [3])
    assert svc.stats["programs"]["hits"] == 1
    assert svc.stats["programs"]["misses"] == 0
    got2 = _drain(svc, [ttsp.random_instance(20, seed=5)], [6])
    st = svc.stats["programs"]
    assert st["misses"] == 1
    assert st["missed_signatures"][0]["bucket"] == 32
    assert np.isfinite(got[0].best_len) and np.isfinite(got2[0].best_len)


ROUTED = [
    pytest.param(_counter(variant="as", iterations=5), 12, 31, id="as"),
    pytest.param(_counter(variant="mmas", iterations=5), 12, 31, id="mmas"),
    pytest.param(_counter(variant="acs", iterations=5), 12, 31, id="acs"),
    pytest.param(_counter(variant="mmas", tau_dtype="int8",
                          tau_round="nearest"), 12, 13, id="int8"),
    pytest.param(_counter(variant="mmas", sparse=True, sparse_k=8), 12, 17,
                 id="sparse"),
    pytest.param(_counter(variant="mmas", use_pallas=True), 12, 31,
                 id="mmas-kernel"),
]


@pytest.mark.parametrize("kw,n,inst_seed", ROUTED)
def test_neighbour_bucket_bitwise_exact(kw, n, inst_seed):
    """n = 12 (native bucket 16) routed into a warmed-only bucket 32 is
    bitwise the native run in the port, and its tour and length bitwise
    the reference's native run; the routed engine run's tau is the
    reference's native tau within the contract."""
    kind = "sparse" if kw.get("sparse") else "dense"
    inst = ttsp.random_instance(n, seed=inst_seed)
    want = _drain(tsvc.SolverService(taco.ACOConfig(**kw), max_batch=2,
                                     device="cpu"), [inst], [8])
    pc = tprog.ProgramCache()
    svc = tsvc.SolverService(taco.ACOConfig(**kw), max_batch=2, programs=pc,
                             device="cpu")
    svc.warm_programs(20, 20)                 # ladder = [32] only
    assert pc.warmed_buckets(kind) == (32,)
    assert svc._route_bucket(inst.n) == 32    # 16 is cold -> neighbour
    got = _drain(svc, [inst], [8])
    assert got[0].bucket == 32
    assert svc.stats["programs"]["hits"] == 1
    assert svc.stats["programs"]["misses"] == 0
    _same(want, got)
    jkw = {k: v for k, v in kw.items() if k != "use_pallas"}
    ref = _drain(jsvc.SolverService(jaco.ACOConfig(**jkw), max_batch=2),
                 [jtsp.random_instance(n, seed=inst_seed)], [8])
    _same(ref, got)
    # the engine run behind the routed result, against the reference's
    # native run: tau on the real block
    its = [kw["iterations"]]
    st, _ = teng.solve_instances([inst], taco.ACOConfig(**kw),
                                 iterations=its, seeds=[8], n_pad=32,
                                 device="cpu")
    jst, _ = jeng.solve_instances([jtsp.random_instance(n, seed=inst_seed)],
                                  jaco.ACOConfig(**jkw), iterations=its,
                                  seeds=[8], n_pad=16)
    assert_bitwise(to_np(st.best_tour)[0][:n], np.asarray(jst.best_tour)[0]
                   [:n], "best_tour")
    tau, jtau = st.tau, jst.tau
    if kind == "sparse":
        np.testing.assert_allclose(to_np(tau.q if hasattr(tau, "q") else tau)
                                   [0][:n], np.asarray(jtau)[0][:n], **TOL)
    elif hasattr(tau, "q"):
        assert_bitwise(to_np(tau.q)[0][:n, :n], np.asarray(jtau.q)[0][:n, :n],
                       "tau payload")
        np.testing.assert_allclose(to_np(tau.scale)[0][:n],
                                   np.asarray(jtau.scale)[0][:n], **TOL)
    else:
        np.testing.assert_allclose(to_np(tau)[0][:n, :n],
                                   np.asarray(jtau)[0][:n, :n], **TOL)


def test_packed_draw_mode_never_neighbour_routes():
    """Packed draws are width-dependent: an attached cache keeps the
    native bucket rather than route."""
    pc = tprog.ProgramCache()
    svc = tsvc.SolverService(taco.ACOConfig(iterations=3, seed=0),
                             max_batch=2, programs=pc, device="cpu")
    svc.warm_programs(20, 20)                      # warmed: {32}
    assert svc._route_bucket(12) == 16             # refused, stays native


def test_streaming_warmed_hits_and_bucket_stamp():
    """Warmed chunks hit (no miss), results bitwise the plain pool's and
    the reference's."""
    base = dict(iterations=4, seed=0, selection="gumbel")
    specs = WARM_INSTS[:2]

    def run(svc, mod):
        for k, inst in enumerate(_insts(mod, specs)):
            svc.submit(inst, iterations=4, seed=40 + k)
        return sorted(svc.run_until_drained(), key=lambda r: r.request_id)

    want = run(tstream.StreamingSolverService(
        taco.ACOConfig(**base), max_batch=2, chunk=2, device="cpu"), ttsp)
    pc = tprog.ProgramCache()
    svc = tstream.StreamingSolverService(taco.ACOConfig(**base), max_batch=2,
                                         chunk=2, programs=pc, device="cpu")
    svc.warm_programs(10, 12)
    got = run(svc, ttsp)
    st = svc.stats["programs"]
    assert st["hits"] > 0 and st["misses"] == 0
    _same(want, got)
    ref = run(jstream.StreamingSolverService(jaco.ACOConfig(**base),
                                             max_batch=2, chunk=2), jtsp)
    _same(ref, got)


def test_streaming_neighbour_route_stamped_at_submit():
    """A neighbour-routed streaming request records its routed bucket at
    submit and solves bitwise as the native one."""
    kw = _counter(iterations=4)
    inst = ttsp.random_instance(12, seed=23)
    plain = tstream.StreamingSolverService(taco.ACOConfig(**kw), max_batch=2,
                                           chunk=2, device="cpu")
    plain.submit(inst, iterations=4, seed=6)
    want = plain.run_until_drained()
    pc = tprog.ProgramCache()
    svc = tstream.StreamingSolverService(taco.ACOConfig(**kw), max_batch=2,
                                         chunk=2, programs=pc, device="cpu")
    svc.warm_programs(20, 20)                 # warmed: {32}
    svc.submit(inst, iterations=4, seed=6)
    assert svc._waiting[0].bucket == 32       # stamped once, at submit
    got = svc.run_until_drained()
    assert svc.stats["programs"]["hits"] > 0
    _same(want, got)


def _solo(kw, inst, n_pad, seed):
    st, _ = teng.solve_instances([inst], taco.ACOConfig(**kw),
                                 iterations=[3], seeds=[seed], n_pad=n_pad,
                                 device="cpu")
    return float(st.best_len[0]), to_np(st.best_tour)[0][:inst.n]


def test_counter_draw_mode_is_width_invariant():
    inst = ttsp.random_instance(10, seed=11)
    a, b = (_solo(_counter(iterations=3), inst, p, 9) for p in (16, 32))
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_packed_draw_mode_is_width_dependent():
    """The gate is load-bearing: packed draws change with the padded
    width."""
    inst = ttsp.random_instance(10, seed=11)
    kw = dict(iterations=3, m=4, seed=0)
    assert any(not np.array_equal(_solo(kw, inst, 16, s)[1],
                                  _solo(kw, inst, 32, s)[1])
               for s in range(6))
