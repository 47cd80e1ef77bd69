"""Port parity for the drain service, checkpoints and the supervisor.

- The port's ``SolverService`` drain equals the reference's on the same
  requests: best lengths, best tours and iterations bitwise; metrics rows
  as tests/test_torch_obs.py holds them (two means at rtol 1e-5 / atol
  1e-7, the rest bitwise).
- A drain with a crash injected after a chunk equals the uninterrupted
  drain, bitwise, metrics rows included.
- Checkpoints of fp32, bf16 and int8 ``ColonyState`` stacks and of a
  quantised ``SparseColonyState`` round-trip bit for bit, onto the
  template's device, and leave no ``.tmp`` behind.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import service as jsvc  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch import obs, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.runtime import Supervisor, SupervisorConfig  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import service as tsvc  # noqa: E402
from repro_torch.sparse import aco as tsaco  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)
SIZES = (10, 12, 14, 20, 24)


def _drain(svc, insts, tenants=None):
    for i, inst in enumerate(insts):
        svc.submit(inst, iterations=4 + i % 3,
                   tenant=None if tenants is None else tenants[i % 2])
    return svc.run()


def _assert_results(ref, got, rows=True):
    assert [r.request_id for r in got] == [r.request_id for r in ref]
    for a, b in zip(ref, got):
        assert (a.name, a.n, a.bucket, a.iterations) == \
            (b.name, b.n, b.bucket, b.iterations)
        assert_bitwise(np.float32(a.best_len), np.float32(b.best_len),
                       "best_len")
        assert_bitwise(a.best_tour, b.best_tour, "best_tour")
        if rows and a.metrics is not None:
            assert set(b.metrics) == set(obs_metrics.FIELDS)
            for f, v in a.metrics.items():
                if f in ("mean_len", "tau_mean"):
                    np.testing.assert_allclose(v, b.metrics[f], **TOL)
                else:
                    assert v == b.metrics[f], f


@pytest.mark.parametrize("kw", [
    dict(variant="mmas", metrics=True),
    dict(variant="as", selection="gumbel", local_search="2opt",
         ls_rounds=4),
    dict(variant="acs", use_pallas=True),
])
def test_drain_equals_reference_service(kw):
    """Two buckets (16 and 32), max_batch 2, patience 3, two tenants."""
    insts = [jtsp.circle_instance(n, seed=n) for n in SIZES]
    ref = _drain(jsvc.SolverService(jaco.ACOConfig(**kw), max_batch=2,
                                    patience=3), insts, ("a", "b"))
    svc = tsvc.SolverService(taco.ACOConfig(**kw), max_batch=2, patience=3,
                             device="cpu")
    got = _drain(svc, insts, ("a", "b"))
    _assert_results(ref, got)
    st = svc.stats
    assert st["buckets"] == {"16": 3, "32": 2} and st["batches"] == 3
    assert st["instances_per_s"] > 0
    assert st["latency_max_s"] >= st["latency_mean_s"] > 0
    assert set(st["tenants"]) == {"a", "b"}
    assert {r.tenant for r in got} == {"a", "b"}
    for r in got:
        assert ttsp.is_valid_tour(r.best_tour) and len(r.best_tour) == r.n
        assert r.solve_s > 0 and r.trace_id


def test_sparse_drain_equals_reference_service():
    insts = [jtsp.random_instance(n, seed=n) for n in (20, 25, 30)]
    kw = dict(variant="mmas", sparse=True, sparse_k=6, sparse_overflow=2,
              m=8, iterations=4)
    ref = _drain(jsvc.SolverService(jaco.ACOConfig(**kw)), insts)
    got = _drain(tsvc.SolverService(taco.ACOConfig(**kw), device="cpu"),
                 insts)
    _assert_results(ref, got)


def test_crash_recovery_equals_uninterrupted_drain(tmp_path, monkeypatch):
    """A crash after a chunk restores the newest checkpoint; the chunked,
    crashed drain equals the uninterrupted one bitwise -- with patience,
    whose counters, and the metrics rows, are checkpointed beside the
    state.  Its trace and events validate."""
    insts = [ttsp.circle_instance(n, seed=n) for n in (10, 12, 14)]
    cfg = taco.ACOConfig(iterations=6, variant="mmas", metrics=True)
    ref = _drain(tsvc.SolverService(cfg, max_batch=4, patience=3,
                                    device="cpu"), insts)

    real_run_batch = teng.run_batch
    crashes = {"left": 1}

    def flaky(problem, states, budgets, cfg_, max_iters, patience=0,
              since=None, **kw):
        out = real_run_batch(problem, states, budgets, cfg_, max_iters,
                             patience, since, **kw)
        if int(out[0].iteration.max()) >= 4 and crashes["left"]:
            crashes["left"] -= 1
            raise RuntimeError("injected crash after chunk")
        return out

    monkeypatch.setattr(teng, "run_batch", flaky)
    tel = obs.Telemetry(events_path=str(tmp_path / "events.jsonl"))
    svc = tsvc.SolverService(cfg, max_batch=4, patience=3,
                             checkpoint_dir=str(tmp_path / "ck"),
                             ckpt_chunk=2, telemetry=tel, device="cpu")
    got = _drain(svc, insts)
    tel.close()
    assert crashes["left"] == 0, "crash was never injected"
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert a.best_len == b.best_len and a.iterations == b.iterations
        assert_bitwise(a.best_tour, b.best_tour, "best_tour")
        assert a.metrics == b.metrics
    job_dir = tmp_path / "ck" / "job0000_b16"
    assert sorted(os.listdir(job_dir)) == [
        f"ckpt_{s:09d}.npz" for s in (1, 2, 3)]
    trace = tel.tracer.to_chrome()
    assert validate.validate_chrome_trace(trace) == \
        len(trace["traceEvents"])
    assert validate.validate_event_log_file(
        str(tmp_path / "events.jsonl")) == 3 + 3 + 1
    kinds = [e["kind"] for e in tel.events.records()]
    assert kinds.count("submit") == kinds.count("harvest") == 3


def test_metrics_off_drain_equals_metrics_on(tmp_path):
    insts = [ttsp.circle_instance(n, seed=n) for n in (10, 12, 14)]
    kw = dict(iterations=5, variant="mmas")
    on = _drain(tsvc.SolverService(taco.ACOConfig(metrics=True, **kw),
                                   max_batch=2, device="cpu",
                                   checkpoint_dir=str(tmp_path),
                                   ckpt_chunk=3), insts)
    off = _drain(tsvc.SolverService(taco.ACOConfig(**kw), max_batch=2,
                                    device="cpu"), insts)
    _assert_results(on, off, rows=False)
    assert all(r.metrics is None for r in off)
    assert all(r.metrics["best_len"] == r.best_len for r in on)


def test_health_and_slo():
    svc = tsvc.SolverService(taco.ACOConfig(iterations=3), max_batch=2,
                             device="cpu")
    h0 = svc.health()
    assert h0["mode"] == "drain" and h0["jobs_run"] == 0
    for i, t in enumerate(("x", None, "x")):
        svc.submit(ttsp.random_instance(10 + i, seed=i), tenant=t)
    assert svc.health()["pending"] == 3
    res = svc.run()
    assert svc.run() == []                              # nothing pending
    assert {r.tenant for r in res} == {"x", None}
    h = svc.health()
    assert h["pending"] == 0 and h["jobs_run"] == 2 and h["devices"] == 1
    assert h["tenants"] == ["default", "x"] and h["uptime_s"] > 0
    s = svc.slo.summary()
    assert s["x"]["completed"] == 2 and s["x"]["attainment"] == 1.0


def test_service_rejections_name_their_items():
    cfg = taco.ACOConfig()
    # warm_programs needs a cache, as in the reference
    with pytest.raises(ValueError, match="no ProgramCache") as want:
        jsvc.SolverService(jaco.ACOConfig()).warm_programs(10, 100)
    with pytest.raises(ValueError, match="no ProgramCache") as got:
        tsvc.SolverService(cfg, device="cpu").warm_programs(10, 100)
    assert str(got.value) == str(want.value)
    # a mesh is served (tests/test_torch_mesh.py), a sparse one refused
    # with the reference's message
    mesh = Mesh([torch.device("cpu")] * 2, ("data",))
    assert tsvc.SolverService(cfg, mesh=mesh).devices == 2
    with pytest.raises(Exception) as want:
        jsvc.SolverService(jaco.ACOConfig(sparse=True), mesh=object())
    with pytest.raises(tops.UnsupportedKernelRoute) as got:
        tsvc.SolverService(taco.ACOConfig(sparse=True), mesh=mesh)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="deposit"):
        tsvc.SolverService(taco.ACOConfig(deposit="nope"), device="cpu")
    # the whole deposit ladder is served; an unknown name lists it as the
    # reference does
    with pytest.raises(ValueError) as want:
        jsvc.SolverService(jaco.ACOConfig(deposit="nope"))
    with pytest.raises(ValueError) as got:
        tsvc.SolverService(taco.ACOConfig(deposit="nope"), device="cpu")
    assert str(got.value) == str(want.value)
    for dep in ("s2g", "s2g_tiled", "onehot"):
        kw = dict(deposit=dep, variant="mmas", m=6)
        insts = [jtsp.circle_instance(12, seed=1)]
        _assert_results(_drain(jsvc.SolverService(jaco.ACOConfig(**kw)),
                               insts),
                        _drain(tsvc.SolverService(taco.ACOConfig(**kw),
                                                  device="cpu"), insts))
    tsvc.SolverService(taco.ACOConfig(use_pallas=True), device="cpu")
    # the sparse check at construction keeps the reference's message
    for kw in (dict(selection="roulette"), dict(local_search="2opt"),
               dict(construction="partial")):
        with pytest.raises(Exception) as want:
            jsvc.SolverService(jaco.ACOConfig(sparse=True, **kw))
        with pytest.raises(tops.UnsupportedKernelRoute) as got:
            tsvc.SolverService(taco.ACOConfig(sparse=True, **kw),
                               device="cpu")
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsvc.SolverService(cfg)


# ------------------------------------------------------------ checkpoints
def _stack_state(**kw):
    insts = [ttsp.random_instance(n, seed=n) for n in (10, 14)]
    cfg = taco.ACOConfig(iterations=3, **kw)
    st, _ = teng.solve_instances(insts, cfg, n_pad=16, device="cpu")
    return st


@pytest.mark.parametrize("kw", [dict(), dict(tau_dtype="bf16"),
                                dict(tau_dtype="int8", variant="mmas",
                                     tau_compensation=True)])
def test_state_stack_roundtrip_bitwise(tmp_path, kw):
    st = _stack_state(**kw)
    path = str(tmp_path / "c.npz")
    ck.save_pytree(path, st, step=3)
    assert os.listdir(tmp_path) == ["c.npz"]           # no .tmp left
    template = tree.map(torch.zeros_like, st)
    rest = ck.load_pytree(path, template)
    for a, b in zip(tree.flatten(st), tree.flatten(rest)):
        assert a.dtype == b.dtype and a.device == b.device
        assert_bitwise(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a,
                       b.view(torch.int16) if b.dtype == torch.bfloat16
                       else b, "leaf")


def test_sparse_state_roundtrip_and_resume_bitwise(tmp_path):
    """A quantised sparse state saved mid-run resumes to the
    uninterrupted trajectory, bit for bit."""
    inst = ttsp.random_instance(30, seed=2)
    kw = dict(variant="mmas", sparse=True, sparse_k=5, sparse_overflow=2,
              m=8, tau_dtype="int8")
    full = tsaco.run_sparse(inst, taco.ACOConfig(iterations=6, **kw),
                            device="cpu")
    half = tsaco.run_sparse(inst, taco.ACOConfig(iterations=3, **kw),
                            device="cpu")
    mgr = ck.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, half)
    restored, step = mgr.restore(tree.map(torch.zeros_like, half))
    assert step == 3
    resumed = tsaco.run_sparse(inst, taco.ACOConfig(iterations=6, **kw),
                               state=restored)
    for a, b in zip(tree.flatten(full), tree.flatten(resumed)):
        assert_bitwise(a, b, "resumed")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_manager_retention_async_and_stale_tmp(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "keep"), keep=2,
                               async_write=False)
    state = {"a": torch.arange(4), "b": torch.ones((2, 2))}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4

    amgr = ck.CheckpointManager(str(tmp_path / "async"), keep=5)
    x = torch.full((32, 32), 7.0)
    for s in range(3):
        amgr.save(s, {"x": x})
        x.add_(1.0)                 # the save copied it: no effect on disk
    amgr.wait()
    assert amgr.all_steps() == [0, 1, 2]
    rest, step = amgr.restore({"x": torch.empty((32, 32))})
    assert step == 2 and (rest["x"] == 9.0).all()

    # an interrupted write leaves a .tmp, never a truncated checkpoint
    open(tmp_path / "keep" / "ckpt_000000005.npz.tmp", "w").close()
    assert mgr.restore(state)[1] == 4
    with pytest.raises(ValueError, match="tensors"):
        mgr.restore({"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        ck.CheckpointManager(str(tmp_path / "empty")).restore(state)


# ------------------------------------------------------------- supervisor
def _colony_workload(path, crash_at=None, deadline=None, slow_at=None):
    inst = ttsp.circle_instance(24, seed=2)
    cfg = taco.ACOConfig(selection="gumbel", tau_dtype="int8")
    problem = taco.make_problem(inst, cfg.nn_k, device="cpu")
    events = {"crash": crash_at is not None, "slow": slow_at is not None}

    def step(state, i):
        if i == crash_at and events["crash"]:
            events["crash"] = False
            raise RuntimeError("injected preemption")
        if i == slow_at and events["slow"]:
            events["slow"] = False
            time.sleep(0.5)               # a straggler, once
        return taco.colony_step(problem, state, cfg)[0]

    mgr = ck.CheckpointManager(str(path), keep=2, async_write=False)
    return Supervisor(SupervisorConfig(total_steps=12, ckpt_every=4,
                                       step_deadline_s=deadline),
                      mgr, lambda: taco.init_colony(inst, cfg,
                                                    device="cpu"), step)


@pytest.mark.parametrize("fault", ["crash", "deadline"])
def test_supervisor_restart_reproduces_trajectory(tmp_path, fault):
    clean = _colony_workload(tmp_path / "clean").run()
    sup = _colony_workload(
        tmp_path / "fault", crash_at=6 if fault == "crash" else None,
        slow_at=6 if fault == "deadline" else None,
        deadline=0.25 if fault == "deadline" else None)
    out = sup.run()
    assert sup.restarts == 1
    for a, b in zip(tree.flatten(clean), tree.flatten(out)):
        assert_bitwise(a, b, fault)
    assert int(out.iteration) == 12


def test_supervisor_restart_budget_enforced(tmp_path):
    inst = ttsp.circle_instance(16, seed=3)
    cfg = taco.ACOConfig()
    mgr = ck.CheckpointManager(str(tmp_path), async_write=False)

    def bad_step(state, i):
        raise RuntimeError("permanently broken node")

    sup = Supervisor(SupervisorConfig(total_steps=5, max_restarts=2), mgr,
                     lambda: taco.init_colony(inst, cfg, device="cpu"),
                     bad_step)
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        sup.run()
    assert sup.restarts == 3


@pytest.mark.parametrize("ckpt", [False, True])
def test_warmed_service_equals_the_reference(ckpt, tmp_path):
    """``SolverService(programs=)`` after ``warm_programs``: jobs padded
    to ``max_batch`` with phantom slots, plain and checkpointed, equal the
    reference's plain drain bitwise; the plain drain hits every job."""
    from repro_torch.solver.programs import ProgramCache
    kw = dict(iterations=6, variant="mmas", seed=0)
    insts = [jtsp.circle_instance(n, seed=n) for n in SIZES]
    ref = _drain(jsvc.SolverService(jaco.ACOConfig(**kw), max_batch=4),
                 insts)
    pc = ProgramCache()
    svc = tsvc.SolverService(
        taco.ACOConfig(**kw), max_batch=4, programs=pc, device="cpu",
        checkpoint_dir=str(tmp_path) if ckpt else None, ckpt_chunk=2)
    summary = svc.warm_programs(min(SIZES), max(SIZES))
    assert sorted(summary["buckets"]) == ["16", "32"]
    assert not summary["errors"]
    got = _drain(svc, insts)
    _assert_results(ref, got)
    st = svc.stats["programs"]
    assert st["hits"] + st["misses"] > 0
    if not ckpt:
        assert st["misses"] == 0 and st["hits"] == svc.stats["batches"]
