"""Port parity for the streaming service (``repro_torch.solver.streaming``).

The cases of tests/test_streaming.py, each held against
``repro.solver.streaming`` on the same seeded instances and submissions:
results (best length, best tour, iterations, expiry, bucket) bitwise, and
bitwise the port's own solo ``engine.run_batch`` of each request.  The
kernel route (``use_pallas=True``, the batched step) is added beside the
reference's pure-route cases.  Metrics rows: ``mean_len`` and
``tau_mean`` at rtol 1e-5 / atol 1e-7 (XLA's fused sum order), the rest
bitwise.  Admission, eviction, stats, Hyper profiles and trace replay
are in tests/test_torch_streaming_admission.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import streaming as jstream  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
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


def test_streaming_rejections_keep_reference_messages():
    """pallas x per-instance Hyper, an unknown deposit and sparse
    streaming raise as the reference does, with its messages (over a mesh
    too); warm_programs without a cache raises as the reference's."""
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
    # the whole deposit ladder is served; an unknown name lists it as the
    # reference does
    with pytest.raises(ValueError) as want:
        jstream.StreamingSolverService(jaco.ACOConfig(deposit="nope"))
    with pytest.raises(ValueError) as got:
        tstream.StreamingSolverService(taco.ACOConfig(deposit="nope"),
                                       device="cpu")
    assert str(got.value) == str(want.value)
    for dep in ("s2g", "s2g_tiled", "onehot"):
        svc_j, svc_t = _services(dict(deposit=dep, variant="mmas", m=6),
                                 max_batch=2)
        for svc, inst in ((svc_j, J_INSTS[0]), (svc_t, T_INSTS[0])):
            svc.submit(inst, iterations=3, seed=1)
        _assert_same(svc_j.run_until_drained(), svc_t.run_until_drained())
    mesh = Mesh([torch.device("cpu")] * 3, ("data",))
    assert tstream.StreamingSolverService(taco.ACOConfig(),
                                          mesh=mesh).stats["devices"] == 3
    with pytest.raises(tops.UnsupportedKernelRoute, match="streaming pool"):
        tstream.StreamingSolverService(taco.ACOConfig(sparse=True),
                                       mesh=mesh)
    with pytest.raises(ValueError, match="no ProgramCache") as want:
        jstream.StreamingSolverService(jaco.ACOConfig()).warm_programs(10,
                                                                       100)
    with pytest.raises(ValueError, match="no ProgramCache") as got:
        tstream.StreamingSolverService(taco.ACOConfig(),
                                       device="cpu").warm_programs(10, 100)
    assert str(got.value) == str(want.value)
    for bad, match in ((dict(chunk=0), "chunk"),
                       (dict(max_waiting=0), "max_waiting")):
        with pytest.raises(ValueError, match=match):
            tstream.StreamingSolverService(taco.ACOConfig(), device="cpu",
                                           **bad)


# ------------------------------------------------------- deadline eviction


# ------------------------------------------------- per-instance hyper


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


def test_streaming_pool_and_service_with_programs():
    """``StreamingPool(programs=)`` steps its chunks through a warmed
    program (hits), bitwise the plain pool; the service with
    ``programs=`` stamps buckets at submit and reports the cache's stats,
    its results bitwise the reference's."""
    from repro_torch.solver.programs import ProgramCache
    kw = dict(iterations=4, variant="mmas", selection="gumbel", seed=0)
    cfg = taco.ACOConfig(use_pallas=True, **kw)
    pc = ProgramCache()
    pc.warm([16], 2, cfg, 2, donate=True, device="cpu")
    reqs = [tstream.StreamRequest(request_id=i, instance=inst, iterations=b,
                                  seed=s)
            for i, (inst, b, s) in enumerate(zip(T_INSTS[:2], BUDGETS,
                                                 SEEDS))]
    pools = [tstream.StreamingPool(16, 2, cfg, device="cpu",
                                   programs=p) for p in (None, pc)]
    for pool in pools:
        pool.fill_slots([(i, dataclasses.replace(r)) for i, r in
                         enumerate(reqs)])
        for _ in range(4):
            pool.step_chunk(2)
    for a, b in zip(tree.flatten(pools[0].states),
                    tree.flatten(pools[1].states)):
        assert_bitwise(a, b, "pool")
    assert pc.stats()["hits"] == 4 and pc.stats()["misses"] == 0
    pc = ProgramCache()
    svc = tstream.StreamingSolverService(taco.ACOConfig(**kw), max_batch=2,
                                         chunk=2, programs=pc, device="cpu")
    svc.warm_programs(10, 13)
    ref = jstream.StreamingSolverService(jaco.ACOConfig(**kw), max_batch=2,
                                         chunk=2)
    results = []
    for s, insts in ((ref, J_INSTS), (svc, T_INSTS)):
        for inst, b, seed in zip(insts[:3], BUDGETS, SEEDS):
            s.submit(inst, iterations=b, seed=seed)
        results.append(sorted(s.run_until_drained(),
                              key=lambda r: r.request_id))
    assert all(r.bucket == 16 for r in results[1])
    for a, b in zip(*results):
        assert_bitwise(np.float32(a.best_len), np.float32(b.best_len))
        assert_bitwise(a.best_tour, b.best_tour)
    st = svc.stats["programs"]
    assert st["hits"] > 0 and st["misses"] == 0
