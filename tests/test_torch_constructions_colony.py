"""Port parity for whole colonies over the paper's construction ladder:
``task_baseline``, ``task_choice``, ``nn_list`` and ``nn_list_eager``
through repro_torch.core.aco, the engine's per-slot loop and both
services, against repro.core.aco and repro.solver.

``colony_step`` on the pure route and on the kernel route (where the
choice matrix comes from ``ops.choice_info``, K3's plain twin on the CPU,
and the update from ``ops.pheromone_update``, K2's), ``aco.run`` with an
s2g deposit, ``SolverService`` and ``StreamingSolverService`` with
``construction="task_choice", deposit="s2g"``, and the ladder under a
warmed ``ProgramCache``.  The constructions alone:
tests/test_torch_constructions.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.solver import service as jsvc  # noqa: E402
from repro.solver import streaming as jstream  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.solver import service as tsvc  # noqa: E402
from repro_torch.solver import streaming as tstream  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

LADDER = ("task_baseline", "task_choice", "nn_list", "nn_list_eager")


def _colony_pair(kw, n=24, seed=4):
    inst = jtsp.random_instance(n, seed=seed)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    return (inst, cj, jaco.make_problem(inst, cj.nn_k),
            jaco.init_colony(inst, cj)), \
        (ct, taco.make_problem(inst, ct.nn_k, device="cpu"),
         taco.init_colony(inst, ct, device="cpu"))


ROUTE_CASES = [(method, variant, pallas)
               for method in LADDER
               for variant in ("as", "mmas")
               for pallas in (False, True)]


def _count_ops(monkeypatch, calls):
    """Count the ``ops`` calls the colony step makes (plain on the CPU)."""
    for name in ("choice_info", "pheromone_update"):
        real = getattr(tops, name)

        def call(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, call)


@pytest.mark.parametrize("method,variant,use_pallas", ROUTE_CASES)
def test_colony_is_the_reference(method, variant, use_pallas, monkeypatch):
    """Three iterations of ``colony_step`` with each construction on the
    pure route (rho 0.1) and the kernel route (rho 0.5, as in
    test_torch_aco.py: at other rates the reference's one-step Pallas
    update grid fuses the evaporation product into the deposit): tours,
    lengths, best and key bitwise; tau bitwise, except AS on the kernel
    route within rtol 1e-5 / atol 1e-7 (several ants a cell)."""
    kw = dict(variant=variant, construction=method, use_pallas=use_pallas,
              rho=0.5 if use_pallas else 0.1, nn_k=8, m=12, iterations=3)
    (_, cj, pj, sj), (ct, pt, st) = _colony_pair(kw)
    calls = {"choice_info": 0, "pheromone_update": 0}
    _count_ops(monkeypatch, calls)
    for i in range(3):
        sj, bj = jaco.colony_step(pj, sj, cj)
        st, bt = taco.colony_step(pt, st, ct)
        assert_bitwise(bj, bt, f"step {i} iteration best")
        assert_bitwise(sj.best_tour, st.best_tour, f"step {i} best tour")
        assert_bitwise(sj.best_len, st.best_len, f"step {i} best length")
        assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key,
                       f"step {i} key")
        if use_pallas and variant == "as":
            np.testing.assert_allclose(np.asarray(sj.tau), st.tau.numpy(),
                                       rtol=1e-5, atol=1e-7)
        else:
            assert_bitwise(sj.tau, st.tau, f"step {i} tau")
    # one choice_info and one update a step on the kernel route, no
    # choice_info for task_baseline, which reads no choice matrix
    reads_choice = method != "task_baseline"
    assert calls == {
        "choice_info": 3 if use_pallas and reads_choice else 0,
        "pheromone_update": 3 if use_pallas else 0}


@pytest.mark.parametrize("method", LADDER)
def test_run_is_the_reference(method):
    kw = dict(variant="as", construction=method, nn_k=8, m=10,
              iterations=3, deposit="s2g_tiled", deposit_tile=16)
    (inst, cj, _, _), (ct, _, _) = _colony_pair(kw, n=20, seed=8)
    sj = jaco.run(inst, cj)
    st = taco.run(inst, ct, device="cpu")
    assert_bitwise(sj.best_tour, st.best_tour, "best tour")
    assert_bitwise(sj.best_len, st.best_len, "best length")
    np.testing.assert_allclose(np.asarray(sj.tau), st.tau.numpy(),
                               rtol=1e-5, atol=1e-7)


def _served(svc, mod, drain):
    for k, n in enumerate((12, 15, 14)):       # one bucket of 16
        svc.submit(mod.random_instance(n, seed=n), iterations=2 + k,
                   seed=k)
    res = svc.run() if drain else svc.run_until_drained()
    return sorted(res, key=lambda r: r.request_id)


@pytest.mark.parametrize("drain", [True, False])
def test_services_serve_the_ladder(drain):
    """``SolverService`` (drain) and ``StreamingSolverService`` with
    ``construction="task_choice", deposit="s2g"`` give the reference's
    results (the engine's per-slot loop)."""
    kw = dict(variant="mmas", construction="task_choice", deposit="s2g",
              m=8)
    if drain:
        svc_j = jsvc.SolverService(jaco.ACOConfig(**kw), max_batch=2)
        svc_t = tsvc.SolverService(taco.ACOConfig(**kw), max_batch=2,
                                   device="cpu")
    else:
        svc_j = jstream.StreamingSolverService(jaco.ACOConfig(**kw),
                                               max_batch=2, chunk=2)
        svc_t = tstream.StreamingSolverService(taco.ACOConfig(**kw),
                                               max_batch=2, chunk=2,
                                               device="cpu")
    rj = _served(svc_j, jtsp, drain)
    rt = _served(svc_t, ttsp, drain)
    assert len(rj) == len(rt) == 3
    for a, b in zip(rj, rt):
        assert (a.request_id, a.n, a.iterations) == \
            (b.request_id, b.n, b.iterations)
        assert_bitwise(a.best_tour, b.best_tour, "best tour")
        assert_bitwise(np.float32(a.best_len), np.float32(b.best_len),
                       "best length")


@pytest.mark.parametrize("kw", [
    dict(construction="task_choice", deposit="s2g"),
    dict(construction="nn_list", use_pallas=True),
    dict(construction="task_baseline", use_pallas=True)])
def test_ladder_under_a_program_cache_runs_eager(kw):
    """A warmed ``ProgramCache`` serves the ladder's configs on the
    engine's per-slot loop, eagerly: the drain equals one without the
    cache, and the warmed signatures are hit."""
    from repro_torch.solver import ProgramCache
    cfg = taco.ACOConfig(variant="mmas", m=8, **kw)
    out = []
    for pc in (ProgramCache(), None):
        svc = tsvc.SolverService(cfg, max_batch=2, programs=pc,
                                 device="cpu")
        if pc is not None:
            assert svc.warm_programs(10, 32)["errors"] == []
        for n in (12, 20, 17):
            svc.submit(ttsp.random_instance(n, seed=n), iterations=3)
        out.append(svc.run())
        if pc is not None:
            assert pc.stats()["hits"] == 2 and pc.stats()["misses"] == 0
    for a, b in zip(*out):
        assert_bitwise(a.best_tour, b.best_tour, "best tour")
        assert a.best_len == b.best_len
