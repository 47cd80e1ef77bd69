"""Port parity for the streaming service (``repro_torch.solver.streaming``).

The cases of tests/test_streaming.py, each held against
``repro.solver.streaming`` on the same seeded instances and submissions:
results (best length, best tour, iterations, expiry, bucket) bitwise, and
bitwise the port's own solo ``engine.run_batch`` of each request.  The
kernel route (``use_pallas=True``, the batched step) is added beside the
reference's pure-route cases.  Metrics rows: ``mean_len`` and
``tau_mean`` at rtol 1e-5 / atol 1e-7 (XLA's fused sum order), the rest
bitwise.  The trace and event log of a short replay validate.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import streaming as jstream  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import streaming as tstream  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)
SPECS = (("random", 10, 1), ("circle", 12, 2), ("random", 13, 3),
         ("circle", 16, 4), ("random", 14, 5))
BUDGETS = (6, 3, 7, 4, 5)
SEEDS = (20, 21, 22, 23, 24)


def _insts(mod):
    return [getattr(mod, f"{kind}_instance")(n, seed=s)
            for kind, n, s in SPECS]


J_INSTS, T_INSTS = _insts(jtsp), _insts(ttsp)


def _services(kw, **svc):
    return (jstream.StreamingSolverService(jaco.ACOConfig(**kw), **svc),
            tstream.StreamingSolverService(taco.ACOConfig(**kw),
                                           device="cpu", **svc))


def _solo(inst, cfg, iterations, seed, n_pad=16, hypers=None):
    st, _ = teng.solve_instances([inst], cfg, iterations=[iterations],
                                 seeds=[seed], n_pad=n_pad, hypers=hypers,
                                 device="cpu")
    return float(st.best_len[0]), st.best_tour[0][:inst.n].numpy()


def _assert_same(ref, got, rows=True):
    """Results of the two services, matched by request id."""
    ref = {r.request_id: r for r in ref}
    got = {r.request_id: r for r in got}
    assert sorted(ref) == sorted(got)
    for k, a in ref.items():
        b = got[k]
        assert (a.n, a.bucket, a.iterations, a.expired) == \
            (b.n, b.bucket, b.iterations, b.expired), k
        assert_bitwise(np.float32(a.best_len), np.float32(b.best_len),
                       f"best_len {k}")
        assert_bitwise(a.best_tour, b.best_tour, f"best_tour {k}")
        if rows and a.metrics is not None:
            assert set(b.metrics) == set(obs_metrics.FIELDS)
            for f, v in a.metrics.items():
                if f in ("mean_len", "tau_mean"):
                    np.testing.assert_allclose(v, b.metrics[f], **TOL)
                else:
                    assert v == b.metrics[f], (k, f)


def _midrun(svc, insts):
    """3 requests, two steps, 2 more arrive mid-run, drain."""
    for k in range(3):
        svc.submit(insts[k], iterations=BUDGETS[k], seed=SEEDS[k])
    results = list(svc.step()) + list(svc.step())
    for k in range(3, 5):
        svc.submit(insts[k], iterations=BUDGETS[k], seed=SEEDS[k])
    results.extend(svc.run_until_drained())
    return results


# ---------------------------------------------------------------- exactness
@pytest.mark.parametrize("variant,ls,pallas", [
    ("as", "none", False), ("mmas", "none", False), ("acs", "none", False),
    ("as", "2opt", False), ("as", "none", True), ("mmas", "none", True),
    ("acs", "none", True),
])
def test_streaming_exactness_with_midrun_admission(variant, ls, pallas):
    """5 requests through 2 slots with chunk=2: every slot is refilled at
    least once mid-run.  Every result equals the reference service's and
    the port's solo run, bitwise."""
    kw = dict(iterations=max(BUDGETS), variant=variant, selection="gumbel",
              local_search=ls, ls_rounds=4, use_pallas=pallas)
    jsvc, tsvc = _services(kw, max_batch=2, min_bucket=16, chunk=2)
    ref, got = _midrun(jsvc, J_INSTS), _midrun(tsvc, T_INSTS)
    _assert_same(ref, got)
    assert tsvc.stats["fills"] == len(SPECS)
    by_id = {r.request_id: r for r in got}
    for k, inst in enumerate(T_INSTS):
        best_len, best_tour = _solo(inst, taco.ACOConfig(**kw), BUDGETS[k],
                                    SEEDS[k])
        assert by_id[k].best_len == best_len, (variant, ls, k)
        np.testing.assert_array_equal(by_id[k].best_tour, best_tour)
        assert by_id[k].iterations == BUDGETS[k]
        assert ttsp.is_valid_tour(by_id[k].best_tour)


@pytest.mark.parametrize("pallas", [False, True])
def test_streaming_chunk_size_is_unobservable(pallas):
    kw = dict(iterations=max(BUDGETS), selection="gumbel", use_pallas=pallas)
    outs = []
    for chunk in (1, 3):
        _, svc = _services(kw, max_batch=2, min_bucket=16, chunk=chunk)
        for k, inst in enumerate(T_INSTS):
            svc.submit(inst, iterations=BUDGETS[k], seed=SEEDS[k])
        outs.append(svc.run_until_drained())
    _assert_same(outs[0], outs[1])


def test_streaming_multi_bucket_pools():
    kw = dict(iterations=4, selection="gumbel", use_pallas=True,
              variant="mmas")
    jsvc, tsvc = _services(kw, max_batch=2, min_bucket=16, chunk=2)
    sizes = (10, 20, 14, 28)
    for svc, mod in ((jsvc, jtsp), (tsvc, ttsp)):
        for i, n in enumerate(sizes):
            svc.submit(mod.circle_instance(n, seed=n), iterations=4, seed=i)
    ref, got = jsvc.run_until_drained(), tsvc.run_until_drained()
    _assert_same(ref, got)
    assert {r.bucket for r in got} == {16, 32}
    assert tsvc.stats["pools"] == 2
    for r in got:
        n = sizes[r.request_id]
        best_len, _ = _solo(ttsp.circle_instance(n, seed=n),
                            taco.ACOConfig(**kw), 4, r.request_id,
                            n_pad=r.bucket)
        assert r.best_len == best_len and len(r.best_tour) == n


# ---------------------------------------------------------------- admission
def test_admission_priority_and_deadline_order():
    kw = dict(iterations=2, selection="gumbel")
    orders = []
    for svc, insts in zip(_services(kw, max_batch=1, min_bucket=16,
                                    chunk=2), (J_INSTS, T_INSTS)):
        a = svc.submit(insts[0], priority=0, seed=1)
        b = svc.submit(insts[1], priority=5, deadline=100.0, seed=2)
        c = svc.submit(insts[2], priority=5, deadline=50.0, seed=3)
        d = svc.submit(insts[3], priority=5, seed=4)
        done = [r.request_id for r in svc.run_until_drained()]
        assert done == [c, b, d, a]
        orders.append(done)
    assert orders[0] == orders[1]


def test_admission_backpressure_max_waiting():
    _, svc = _services(dict(iterations=2, selection="gumbel"), max_batch=1,
                       min_bucket=16, chunk=2, max_waiting=2)
    svc.submit(T_INSTS[0], seed=1)
    svc.submit(T_INSTS[1], seed=2)
    with pytest.raises(tstream.AdmissionError, match="queue full"):
        svc.submit(T_INSTS[2], seed=3)
    assert svc.stats["rejected"] == 1
    svc.run_until_drained()
    svc.submit(T_INSTS[2], seed=3)
    assert svc.waiting == 1


def test_streaming_rejections_keep_reference_messages():
    """pallas x per-instance Hyper, an unknown deposit and sparse
    streaming raise as the reference does, with its messages (over a mesh
    too); programs= names its ROADMAP item."""
    tstream.StreamingSolverService(taco.ACOConfig(use_pallas=True),
                                   device="cpu")
    cases = (
        (dict(use_pallas=True), dict(per_instance_hyper=True)),
        (dict(tau_dtype="int8"), dict(per_instance_hyper=True)),
        (dict(deposit="nope"), {}),
        (dict(sparse=True), {}),
        (dict(sparse=True, selection="roulette"), {}),
    )
    for kw, svc_kw in cases:
        with pytest.raises(Exception) as want:
            jstream.StreamingSolverService(jaco.ACOConfig(**kw), **svc_kw)
        with pytest.raises(Exception) as got:
            tstream.StreamingSolverService(taco.ACOConfig(**kw),
                                           device="cpu", **svc_kw)
        assert type(got.value).__name__ == type(want.value).__name__, kw
        assert str(got.value) == str(want.value), kw
    with pytest.raises(tops.UnsupportedKernelRoute, match="streaming pool"):
        tstream.StreamingSolverService(taco.ACOConfig(sparse=True),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 4"):
        tstream.StreamingSolverService(taco.ACOConfig(deposit="onehot"),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        tstream.StreamingSolverService(taco.ACOConfig(), device="cpu",
                                       programs=object())
    mesh = Mesh([torch.device("cpu")] * 3, ("data",))
    assert tstream.StreamingSolverService(taco.ACOConfig(),
                                          mesh=mesh).stats["devices"] == 3
    with pytest.raises(tops.UnsupportedKernelRoute, match="streaming pool"):
        tstream.StreamingSolverService(taco.ACOConfig(sparse=True),
                                       mesh=mesh)
    svc = tstream.StreamingSolverService(taco.ACOConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        svc.warm_programs(10, 100)
    for bad, match in ((dict(chunk=0), "chunk"),
                       (dict(max_waiting=0), "max_waiting")):
        with pytest.raises(ValueError, match=match):
            tstream.StreamingSolverService(taco.ACOConfig(), device="cpu",
                                           **bad)


# ------------------------------------------------------- deadline eviction
def test_evict_expired_from_waiting_queue():
    kw = dict(iterations=2, selection="gumbel")
    outs = []
    for svc, insts in zip(_services(kw, max_batch=1, min_bucket=16,
                                    chunk=2), (J_INSTS, T_INSTS)):
        live = svc.submit(insts[0], iterations=2, seed=1)
        doomed = svc.submit(insts[1], iterations=2, seed=2, deadline=1e-9)
        time.sleep(0.01)
        results = svc.run_until_drained()
        by = {r.request_id: r for r in results}
        assert by[doomed].expired and by[doomed].iterations == 0
        assert by[doomed].best_len == float("inf")
        assert by[doomed].best_tour.size == 0
        assert not by[live].expired
        s = svc.stats
        assert s["expired"] == 1 and s["expired_waiting"] == 1
        assert s["completed"] == 1
        outs.append(results)
    _assert_same(*outs)


@pytest.mark.parametrize("pallas", [False, True])
def test_evict_expired_running_slot_returns_partial_best(pallas):
    """An expired slot frees with its best tour so far; its sibling runs
    on bitwise its solo run (and the reference pool's results)."""
    outs = []
    for mod, stream, insts in ((jaco, jstream, J_INSTS),
                               (taco, tstream, T_INSTS)):
        cfg = mod.ACOConfig(iterations=10, selection="gumbel",
                            use_pallas=pallas)
        kw = {} if mod is jaco else dict(device="cpu")
        pool = stream.StreamingPool(16, 2, cfg, **kw)
        now = time.perf_counter()
        doomed = stream.StreamRequest(
            request_id=0, instance=insts[0], iterations=10, seed=7,
            submitted_at=now, deadline=0.001, expires_at=now + 0.001)
        sibling = stream.StreamRequest(
            request_id=1, instance=insts[1], iterations=4, seed=8,
            submitted_at=now)
        pool.fill_slots([(0, doomed), (1, sibling)])
        pool.step_chunk(2)
        got = pool.evict_expired(now + 10.0)
        assert [r.request_id for r in got] == [0]
        assert got[0].expired and got[0].iterations == 2
        assert np.isfinite(got[0].best_len)
        assert jtsp.is_valid_tour(got[0].best_tour)
        assert pool.free_slots() == [0]
        pool.step_chunk(2)
        done = pool.harvest()
        assert [r.request_id for r in done] == [1]
        outs.append(got + done)
    _assert_same(*outs)
    best_len, best_tour = _solo(T_INSTS[1], taco.ACOConfig(
        iterations=10, selection="gumbel", use_pallas=pallas), 4, 8)
    assert outs[1][1].best_len == best_len
    np.testing.assert_array_equal(outs[1][1].best_tour, best_tour)


def test_evicted_slot_is_refilled_exactly():
    kw = dict(iterations=30, selection="gumbel", use_pallas=True)
    outs = []
    for svc, insts in zip(_services(kw, max_batch=1, min_bucket=16,
                                    chunk=1), (J_INSTS, T_INSTS)):
        hog = svc.submit(insts[0], iterations=30, seed=1)
        succ = svc.submit(insts[1], iterations=3, seed=2)
        assert svc.step() == []
        pool = svc._pools[16][0]
        assert pool.requests[0].request_id == hog
        pool.requests[0].expires_at = time.perf_counter() - 1.0
        results = svc.run_until_drained()
        by = {r.request_id: r for r in results}
        assert by[hog].expired and by[hog].iterations == 1
        assert not by[succ].expired
        s = svc.stats
        assert s["expired"] == 1 and s["expired_running"] == 1
        assert s["fills"] == 2
        outs.append(results)
    _assert_same(*outs)
    best_len, best_tour = _solo(T_INSTS[1], taco.ACOConfig(**kw), 3, 2)
    succ = [r for r in outs[1] if not r.expired][0]
    assert succ.best_len == best_len
    np.testing.assert_array_equal(succ.best_tour, best_tour)


def test_streaming_stats_and_health_shape():
    kw = dict(iterations=3, selection="gumbel")
    stats = []
    for svc, insts in zip(_services(kw, max_batch=2, min_bucket=16,
                                    chunk=1), (J_INSTS, T_INSTS)):
        for k, inst in enumerate(insts[:3]):
            svc.submit(inst, iterations=3, seed=k, tenant="t")
        svc.run_until_drained()
        s = svc.stats
        assert s["submitted"] == 3 and s["completed"] == 3
        assert s["waiting"] == 0 and s["resident"] == 0
        assert s["fills"] == 3 and s["chunks"] >= 3
        assert 0.0 < s["occupancy_mean"] <= 1.0
        assert s["instances_per_s"] > 0
        assert s["latency_p50_s"] <= s["latency_p95_s"] <= \
            s["latency_max_s"]
        stats.append((s, svc.health()))
    (js, jh), (ts, th) = stats
    assert set(js) == set(ts)
    for k in ("submitted", "completed", "fills", "chunks", "slots",
              "buckets", "pools", "devices", "occupancy_mean"):
        assert js[k] == ts[k], k
    assert set(jh) == set(th) and jh["pools"] == th["pools"]
    assert th["mode"] == "streaming" and th["tenants"] == ["t"]


# ------------------------------------------------- per-instance hyper
def test_streaming_mixed_hyper_profiles_exact():
    kw = dict(iterations=5, variant="mmas", selection="gumbel")
    profiles = [None, {"alpha": 2.0, "rho": 0.3}, {"beta": 3.0, "q": 2.0},
                {"rho": 0.8}, {"alpha": 1.5, "beta": 1.0}]
    outs = []
    for svc, insts in zip(_services(kw, max_batch=2, min_bucket=16,
                                    chunk=2, per_instance_hyper=True),
                          (J_INSTS, T_INSTS)):
        for k, inst in enumerate(insts):
            svc.submit(inst, iterations=BUDGETS[k], seed=SEEDS[k],
                       hyper=profiles[k])
        outs.append(svc.run_until_drained())
    _assert_same(*outs)
    cfg = taco.ACOConfig(**kw)
    by = {r.request_id: r for r in outs[1]}
    for k, inst in enumerate(T_INSTS):
        h = taco.Hyper.make(cfg, **(profiles[k] or {}), device="cpu")
        best_len, best_tour = _solo(inst, cfg, BUDGETS[k], SEEDS[k],
                                    hypers=[h])
        assert by[k].best_len == best_len, k
        np.testing.assert_array_equal(by[k].best_tour, best_tour)


def test_streaming_hyper_requires_flag():
    svc = tstream.StreamingSolverService(taco.ACOConfig(iterations=2),
                                         device="cpu")
    with pytest.raises(ValueError, match="per_instance_hyper"):
        svc.submit(T_INSTS[0], hyper={"alpha": 2.0})


# ------------------------------------------------- quantised resident tau
@pytest.mark.parametrize("tau_dtype,pallas", [
    ("int8", False), ("bf16", False), ("int8", True), ("bf16", True)])
def test_streaming_quantised_exactness_with_refill(tau_dtype, pallas):
    kw = dict(iterations=max(BUDGETS), variant="mmas", selection="gumbel",
              tau_dtype=tau_dtype, use_pallas=pallas)
    jsvc, tsvc = _services(kw, max_batch=2, min_bucket=16, chunk=2)
    ref, got = _midrun(jsvc, J_INSTS), _midrun(tsvc, T_INSTS)
    _assert_same(ref, got)
    assert tsvc.stats["fills"] == len(SPECS)
    by = {r.request_id: r for r in got}
    for k, inst in enumerate(T_INSTS):
        best_len, best_tour = _solo(inst, taco.ACOConfig(**kw), BUDGETS[k],
                                    SEEDS[k])
        assert by[k].best_len == best_len, (tau_dtype, k)
        np.testing.assert_array_equal(by[k].best_tour, best_tour)


# ------------------------------------------------------------ trace replay
def test_replay_retries_on_backpressure():
    trace = tstream.make_poisson_trace(6, rate=1e6, min_n=10, max_n=16,
                                       seed=4, iterations=3)
    cfg = taco.ACOConfig(iterations=3, selection="gumbel", use_pallas=True)
    svc = tstream.StreamingSolverService(cfg, max_batch=1, min_bucket=16,
                                         chunk=3, max_waiting=1,
                                         device="cpu")
    results = tstream.replay_trace(svc, trace)
    assert len(results) == 6
    assert svc.stats["rejected"] == 0
    for t, r in zip(trace, sorted(results, key=lambda r: r.request_id)):
        best_len, _ = _solo(t.instance, cfg, t.iterations, t.seed)
        assert r.best_len == best_len


def test_poisson_trace_equals_reference_and_replays(tmp_path):
    """The same trace as the reference's generator; a replay with
    metrics on equals the reference's, and its Chrome trace and event log
    validate."""
    args = dict(num=6, rate=200.0, min_n=10, max_n=16, seed=3,
                iterations=(2, 5), tenants=("a", "b"))
    jt = jstream.make_poisson_trace(**args)
    tt = tstream.make_poisson_trace(**args)
    assert [(a.at, a.instance.n, a.iterations, a.seed, a.tenant)
            for a in jt] == [(b.at, b.instance.n, b.iterations, b.seed,
                              b.tenant) for b in tt]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.instance.coords, b.instance.coords)
    kw = dict(iterations=5, selection="gumbel", variant="mmas",
              use_pallas=True, metrics=True)
    tel = obs.Telemetry(events_path=str(tmp_path / "events.jsonl"))
    jsvc = jstream.StreamingSolverService(jaco.ACOConfig(**kw), max_batch=2,
                                          min_bucket=16, chunk=2)
    tsvc = tstream.StreamingSolverService(taco.ACOConfig(**kw), max_batch=2,
                                          min_bucket=16, chunk=2,
                                          telemetry=tel, snapshot_every=1e-9,
                                          device="cpu")
    ref = jstream.replay_trace(jsvc, jt)
    got = tstream.replay_trace(tsvc, tt)
    tel.close()
    assert len(got) == 6
    _assert_same(ref, got)
    trace = tel.tracer.to_chrome()
    assert validate.validate_chrome_trace(trace) == \
        len(trace["traceEvents"])
    n_events = validate.validate_event_log_file(
        os.path.join(tmp_path, "events.jsonl"))
    kinds = [e["kind"] for e in tel.events.records()]
    assert n_events == len(kinds)
    assert kinds.count("submit") == kinds.count("admit") == \
        kinds.count("harvest") == 6
    assert kinds.count("stats_snapshot") >= 1
    assert set(tsvc.stats["tenants"]) == {"a", "b"}
