"""Port parity for the telemetry fabric: repro_torch.obs against repro.obs.

Per-step metrics (``ACOConfig.metrics=True``), on the same seeded
colonies:

- every StepMetrics field bitwise the reference's, except the two means
  over a float32 sum (``mean_len``, ``tau_mean``): XLA sums a reduction
  fused with its producer in an order of its own, so they are held at
  rtol 1e-5 / atol 1e-7 (ROADMAP queue 3);
- metrics are bitwise neutral: every state field is the same with metrics
  on and off, dense (pure and kernel route, int8 store) and sparse.

The host surfaces (registry, tracer, event log, SLO tracker, Prometheus
renderer, metrics endpoint, validators) are the reference's jax-free
modules copied into the port; their cases from tests/test_obs.py and
tests/test_serving.py run here against the port's copies.
"""
import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import batch as jbatch  # noqa: E402
from repro.solver import engine as jeng  # noqa: E402
from repro.sparse import aco as jsaco  # noqa: E402
from repro_torch import convert, obs, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import serving, validate  # noqa: E402
from repro_torch.obs.registry import Histogram  # noqa: E402
from repro_torch.solver import batch as tbatch  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver.service import SolverService  # noqa: E402
from repro_torch.sparse import aco as tsaco  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)
SUMMED = ("mean_len", "tau_mean")


def assert_metrics(mj, mt, what=""):
    """Reference StepMetrics (any leading shape) against the port's."""
    got = convert.metrics_to_numpy(mt)
    assert set(got) == set(obs_metrics.FIELDS)
    for f, v in got.items():
        want = np.asarray(getattr(mj, f))
        assert want.dtype == v.dtype, (f, want.dtype, v.dtype)
        if f in SUMMED:
            np.testing.assert_allclose(want, v, **TOL, err_msg=f)
        else:
            assert_bitwise(want, v, f"{what} {f}")


def assert_same_state(a, b, what=""):
    for x, y in zip(tree.flatten(a), tree.flatten(b)):
        assert_bitwise(x, y, what)


# ------------------------------------------------ per-step metrics parity
@pytest.mark.parametrize("kw", [
    dict(variant="mmas", local_search="2opt", ls_rounds=4),
    dict(variant="as", rho=0.1),
    dict(variant="acs", use_pallas=True),
])
def test_dense_step_metrics_equal_reference(kw):
    """Dense steps with local search (ls_accept), MMAS clamps (clamp_lo /
    clamp_hi) and the kernel route: each step's row against the
    reference's, fed the same state."""
    inst = jtsp.random_instance(20, seed=4)
    cj = jaco.ACOConfig(metrics=True, **kw)
    ct = taco.ACOConfig(metrics=True, **kw)
    pj = jaco.make_problem(inst, cj.nn_k)
    pt = taco.make_problem(inst, ct.nn_k, device="cpu")
    sj = jaco.init_colony(inst, cj)
    st = taco.init_colony(inst, ct, device="cpu")
    seen = {"clamp_lo": 0.0, "ls_accept": 0.0}
    for i in range(7):          # MMAS reaches tau_min = tau_max / 2n
        sj, bj, mj = jaco.colony_step(pj, sj, cj)
        st, bt, mt = taco.colony_step(pt, st, ct)
        assert_bitwise(bj, bt, f"step {i} it_best")
        assert_metrics(mj, mt, f"step {i}")
        assert_bitwise(sj.best_tour, st.best_tour, f"step {i} best_tour")
        for f in seen:
            seen[f] = max(seen[f], float(getattr(mt, f)))
    if kw["variant"] == "mmas":
        assert seen["clamp_lo"] > 0 and seen["ls_accept"] > 0


def test_sparse_step_metrics_equal_reference():
    """Sparse MMAS with 2 overflow slots per city and k = 4: adoption and
    eviction both occur, and their counts equal the reference's."""
    inst = jtsp.random_instance(40, seed=7)
    kw = dict(variant="mmas", sparse=True, sparse_k=4, sparse_overflow=2,
              m=12, metrics=True)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    ewt = inst.edge_weight_type
    pj = jsaco.make_sparse_problem_cfg(inst, cj)
    pt = tsaco.make_sparse_problem_cfg(inst, ct, device="cpu")
    sj = jsaco.init_sparse_colony(inst, cj)
    st = tsaco.init_sparse_colony(inst, ct, device="cpu")
    adopted = evicted = 0
    for i in range(8):
        sj, _, mj = jsaco.sparse_colony_step(pj, sj, cj, ewt)
        st, _, mt = tsaco.sparse_colony_step(pt, st, ct, ewt)
        assert_metrics(mj, mt, f"sparse step {i}")
        adopted += int(mt.ovf_adopted)
        evicted += int(mt.ovf_evicted)
    assert adopted > 0 and evicted > 0


# ------------------------------------------------------ bitwise neutrality
@pytest.mark.parametrize("kw", [
    dict(variant="as"), dict(variant="mmas"), dict(variant="acs"),
    dict(variant="mmas", use_pallas=True, local_search="2opt",
         ls_rounds=4),
    dict(variant="mmas", tau_dtype="int8"),
])
def test_metrics_neutral_run_scan(kw):
    """run_scan with metrics on: the same final state bitwise, the same
    iteration bests, and a stacked curve of coherent fields."""
    inst = ttsp.random_instance(14, seed=3)
    cfg = taco.ACOConfig(selection="gumbel", **kw)
    prob = taco.make_problem(inst, cfg.nn_k, device="cpu")
    st0 = taco.init_colony(inst, cfg, device="cpu")
    ref, it_best = taco.run_scan(prob, st0, cfg, 6)
    got, (it_best_m, m) = taco.run_scan(
        prob, st0, dataclasses.replace(cfg, metrics=True), 6)
    assert_same_state(ref, got, "state")
    assert_bitwise(it_best, it_best_m, "it_best")
    curve = convert.metrics_to_numpy(m)
    assert curve["it_best_len"].shape == (6,)
    assert np.all(curve["mean_len"] >= curve["it_best_len"] - 1e-3)
    assert np.all(curve["best_len"] <= curve["it_best_len"] + 1e-3)
    assert np.all(curve["stagnation"][curve["improved"] == 1] == 0)
    if kw["variant"] == "mmas":
        assert np.any(curve["clamp_lo"] > 0)
    else:
        assert np.all(curve["clamp_lo"] == 0)


def test_metrics_neutral_sparse():
    inst = ttsp.random_instance(24, seed=7)
    cfg = taco.ACOConfig(iterations=5, variant="mmas", selection="gumbel",
                         sparse=True, sparse_k=8, sparse_overflow=2)
    ref = tsaco.run_sparse(inst, cfg, device="cpu")
    got = tsaco.run_sparse(inst, dataclasses.replace(cfg, metrics=True),
                           device="cpu")
    assert_same_state(ref, got, "sparse state")


def test_run_scan_metrics_aux_equals_reference():
    """The stacked aux of run_scan, stagnation stamped by the loop."""
    inst = jtsp.random_instance(14, seed=3)
    kw = dict(variant="mmas", metrics=True, rho=0.1)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    sj, (bj, mj) = jaco.run_scan(jaco.make_problem(inst, cj.nn_k),
                                 jaco.init_colony(inst, cj), cj, 7)
    st, (bt, mt) = taco.run_scan(
        taco.make_problem(inst, ct.nn_k, device="cpu"),
        taco.init_colony(inst, ct, device="cpu"), ct, 7)
    assert_bitwise(bj, bt, "it_best")
    assert_metrics(mj, mt, "run_scan")
    assert_bitwise(sj.tau, st.tau, "tau")
    assert int(np.asarray(mj.stagnation).max()) > 0


def test_engine_metrics_rows_equal_reference():
    """The engine's (B,) rows, frozen at each instance's last iteration,
    over mixed budgets; the states equal those of a metrics-off run."""
    insts = [jtsp.random_instance(n, seed=n) for n in (10, 13, 16)]
    kw = dict(iterations=7, variant="mmas", metrics=True)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    its, seeds = [5, 7, 3], [1, 2, 3]
    bj = jbatch.make_batch(insts, 16, cj.nn_k)
    sj, since_j, mj = jeng.run_batch(
        bj.problem, jeng.init_states(insts, cj, seeds, 16),
        jnp.asarray(its, jnp.int32), cj, 7)
    bt = tbatch.make_batch(insts, 16, ct.nn_k, device="cpu")
    out = teng.run_batch(bt.problem,
                         teng.init_states(insts, ct, seeds, 16,
                                          device="cpu"), its, ct, 7)
    assert len(out) == 3
    st, since_t, mt = out
    assert_metrics(mj, mt, "rows")
    assert_bitwise(since_j, since_t, "since")
    off = teng.run_batch(bt.problem,
                         teng.init_states(insts, ct, seeds, 16,
                                          device="cpu"), its,
                         dataclasses.replace(ct, metrics=False), 7)
    assert len(off) == 2
    assert_same_state(off[0], st, "metrics off")
    for i in range(3):
        row = obs_metrics.to_host(mt, i)
        assert set(row) == set(obs_metrics.FIELDS)
        assert row["best_len"] == float(st.best_len[i])


# ---------------------------------------------------------------- registry
def test_registry_instruments_and_snapshot():
    r = obs.Registry()
    c = r.counter("fills")
    c.inc()
    c.inc(3)
    assert r.counter("fills") is c and c.value == 4
    r.gauge("occ").set(0.5)
    h = r.histogram("lat", window=4)
    for v in range(1, 11):                       # window keeps only 7..10
        h.observe(float(v))
    assert h.count == 10 and h.total == 55.0
    assert h.mean() == 5.5 and h.max() == 10.0
    assert h.percentile(0) == 7.0 and h.percentile(100) == 10.0
    snap = r.snapshot()
    assert snap["counters"] == {"fills": 4}
    assert snap["gauges"] == {"occ": 0.5}
    s = snap["histograms"]["lat"]
    assert s["count"] == 10 and s["mean"] == 5.5 and s["max"] == 10.0
    assert json.loads(json.dumps(snap)) == snap


def test_histogram_empty_bad_window_and_percentile_edges():
    h = Histogram(window=2)
    assert h.mean() == 0.0 and h.max() == 0.0 and h.percentile(50) == 0.0
    with pytest.raises(ValueError, match="window"):
        Histogram(window=0)
    h = obs.Registry().histogram("lat", window=4)
    h.observe(7.0)
    for q in (0, 50, 99, 100, -5, 500):
        assert h.percentile(q) == 7.0
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    assert h.count == 6 and h.total == 22.0 and h.max() == 7.0
    assert h.percentile(100) == 5.0


def test_registry_labeled_families():
    r = obs.Registry()
    plain, a, b = (r.counter("reqs"), r.counter("reqs", tenant="a"),
                   r.counter("reqs", tenant="b"))
    assert plain is not a and a is not b
    assert r.counter("reqs", tenant="a") is a
    plain.inc()
    a.inc(2)
    b.inc(3)
    snap = r.snapshot()
    assert snap["counters"]["reqs"] == 1
    assert snap["counters"]['reqs{tenant="a"}'] == 2
    assert r.gauge("occ", dev="0", bucket="32") is \
        r.gauge("occ", bucket="32", dev="0")
    assert ("reqs", {"tenant": "a"}, "counter", a) in list(r.families())


# ----------------------------------------------------------------- tracer
def test_tracer_chrome_trace_format_and_bound():
    t = obs.Tracer()
    with t.span("phase", process="dev0", thread="b16", k=1):
        pass
    t.complete("req0", 10.0, 25.0, process="dev0", thread="b16/s0")
    t.instant("admit", process="dev0")
    t.counter("occ", process="dev0", occupied=3)
    ch = t.to_chrome()
    evs = ch["traceEvents"]
    assert json.loads(json.dumps(ch))
    meta = [e for e in evs if e["ph"] == "M"]
    assert {(m["name"], m["args"]["name"]) for m in meta} >= {
        ("process_name", "dev0"), ("thread_name", "b16")}
    assert {s["name"] for s in evs if s["ph"] == "X"} == {"phase", "req0"}
    assert t.track("dev0", "b16") == t.track("dev0", "b16")
    assert {e["ph"] for e in evs} == {"M", "X", "i", "C"}
    assert validate.validate_chrome_trace(ch) == len(evs)
    small = obs.Tracer(max_events=3)
    for i in range(5):
        small.instant(f"e{i}")
    assert small.dropped == 2
    assert len(small.to_chrome()["traceEvents"]) == 3 + 2


def test_eventlog_bounded_and_file_mirror(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = obs.EventLog(path, max_records=3)
    for i in range(5):
        log.emit("tick", i=i)
    log.close()
    assert log.dropped == 2
    assert [r["i"] for r in log.records()] == [2, 3, 4]
    lines = [json.loads(ln) for ln in open(path)]
    assert [r["i"] for r in lines] == list(range(5))
    assert validate.validate_event_log_file(path) == 5


def test_telemetry_snapshot_and_torch_profiler_capture(tmp_path):
    """The torch.profiler hooks: a capture around annotated steps lands
    as a Chrome trace in ``profile_dir`` naming the annotation."""
    tel = obs.Telemetry(profile_dir=str(tmp_path / "prof"))
    assert not tel.profiling
    with tel.step_annotation("chunk", step=0):       # no capture: no-op
        pass
    tel.profile_start()
    assert tel.profiling
    with tel.step_annotation("chunk", step=1):
        torch.ones(8).sum()
    path = tel.profile_stop()
    assert not tel.profiling and os.path.exists(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "chunk step=1" in names
    tel.registry.counter("n").inc()
    snap = tel.snapshot({"extra": 1})
    assert snap["schema"] == obs.SCHEMA == "repro.obs/v1"
    assert snap["registry"]["counters"] == {"n": 1} and snap["extra"] == 1
    tel.write_metrics(str(tmp_path / "m.json"))
    tel.write_trace(str(tmp_path / "t.json"))
    assert validate.validate_chrome_trace(
        json.load(open(tmp_path / "t.json"))) >= 0
    tel.close()


# ---------------------------------------------------------- serving plane
def test_slo_tracker_attainment_and_summary():
    slo = serving.SloTracker(obs.Registry())
    slo.on_submit("a")
    slo.on_submit("a")
    slo.on_submit(None)
    slo.on_reject("b")
    slo.on_admit("a", wait_s=0.1)
    slo.on_admit("a", wait_s=0.2)
    slo.on_outcome("a", "completed", latency_s=0.5, deadline=1.0)
    slo.on_outcome("a", "completed", latency_s=2.0, deadline=1.0)
    slo.on_outcome("b", "expired_waiting", latency_s=3.0, deadline=2.0)
    with pytest.raises(ValueError, match="outcome"):
        slo.on_outcome("a", "vanished", 0.0, None)
    assert slo.tenants == {"a", "b", "default"}
    s = slo.summary()
    assert s["a"]["completed"] == 2 and s["a"]["met"] == 1
    assert s["a"]["attainment"] == pytest.approx(0.5)
    assert s["b"]["rejected"] == 1 and s["b"]["attainment"] == 0.0
    assert s["default"]["submitted"] == 1
    assert json.loads(json.dumps(s)) == s


def test_render_prometheus_text():
    r = obs.Registry()
    r.counter("reqs").inc(4)
    r.counter("reqs", tenant="a").inc(2)
    r.gauge("occupancy").set(0.75)
    h = r.histogram("lat_s", window=8, tenant='we"ird\\')
    h.observe(1.0)
    h.observe(3.0)
    r.gauge("bad name!").set(float("nan"))
    lines = serving.render_prometheus(r).splitlines()
    assert lines.count("# TYPE repro_reqs counter") == 1
    assert "repro_reqs 4" in lines
    assert 'repro_reqs{tenant="a"} 2' in lines
    assert "repro_occupancy 0.75" in lines
    esc = 'tenant="we\\"ird\\\\"'
    assert f'repro_lat_s{{quantile="0.5",{esc}}} 2.0' in lines
    assert f"repro_lat_s_count{{{esc}}} 2" in lines
    assert "repro_bad_name_ NaN" in lines


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_metrics_server_endpoints_over_the_drain_service():
    """The endpoint on localhost serves the port's drain service: SLO
    families, /healthz and the /snapshot schema."""
    svc = SolverService(taco.ACOConfig(iterations=2), max_batch=2,
                        device="cpu")
    server = obs.MetricsServer(
        svc.tel, health_fn=svc.health,
        snapshot_extra_fn=lambda: {"stats": svc.stats}, port=0)
    try:
        svc.submit(ttsp.random_instance(10, seed=0), tenant="acme")
        svc.run()
        status, ctype, body = _get(server.url("/metrics"))
        text = body.decode()
        assert status == 200 and ctype.startswith("text/plain")
        assert 'repro_slo_completed{tenant="acme"} 1' in text
        status, _, body = _get(server.url("/healthz"))
        health = json.loads(body)
        assert health["ok"] is True and health["mode"] == "drain"
        assert "acme" in health["tenants"]
        snap = json.loads(_get(server.url("/snapshot"))[2])
        assert snap["schema"] == "repro.obs/v1"
        assert snap["stats"]["requests"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server.url("/nope"))
        assert ei.value.code == 404
    finally:
        server.close()
        svc.tel.close()


def test_validator_rejects_malformed():
    with pytest.raises(validate.TraceValidationError, match="ph"):
        validate.validate_chrome_trace([{"pid": 1, "tid": 1, "name": "x"}])
    with pytest.raises(validate.TraceValidationError, match="dur"):
        validate.validate_chrome_trace(
            [{"ph": "X", "pid": 1, "tid": 1, "name": "x", "ts": 0,
              "dur": -5}])
    with pytest.raises(validate.TraceValidationError, match="kind"):
        validate.validate_event_log([{"t": 0.0}])
    with pytest.raises(validate.TraceValidationError, match="request_id"):
        validate.validate_event_log(
            [{"t": 0.0, "kind": "harvest", "trace_id": "x", "tenant": "d"}])
    assert validate.validate_event_log(
        [json.dumps({"t": 0.0, "kind": "reject"}),
         {"t": 1.0, "kind": "harvest", "request_id": 0,
          "trace_id": "ab", "tenant": "default"}]) == 2
