"""The card's program path on the CPU (``repro_torch.solver.engine
.EngineProgram``): operands copied into static buffers, a CUDA graph of one
engine iteration per active pattern (here a stand-in capture whose replay
runs the captured iteration), eager iterations otherwise, results copied
out -- bitwise the engine's own path; a call with other shapes falls back
with an ``aot_dispatch_fallback`` event; and the graph routes' iteration
reads nothing from the device, which would break a capture.  The graphs
themselves are held on the card by tests/test_torch_cuda.py (``-k
graph``) and chip_smoke.py [programs].
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.solver import batch as tbatch  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import programs as tprog  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402


class _ReplayEager:
    """Stand-in for a captured graph: a replay runs the iteration."""
    pool_bytes = 0
    launches: dict = {}

    def __init__(self, fn):
        self.fn, self.pool = fn, ("pool",)

    def replay(self):
        self.fn()


@pytest.mark.parametrize("kw,kind", [
    (dict(variant="mmas", metrics=True), "dense"),
    (dict(variant="as", tau_dtype="int8"), "dense"),
    (dict(variant="acs", sparse=True, sparse_k=6, m=8), "sparse"),
])
def test_program_static_buffers_bitwise_engine(kw, kind, monkeypatch):
    """The card's program path (operands copied into static buffers, the
    all-active graph at warm time, another pattern's graph at its second
    sight, eager iterations otherwise, results copied out) is bitwise the
    engine's own path, in place and not."""
    monkeypatch.setattr(teng, "graph_route", lambda *a: True)
    monkeypatch.setattr(teng, "capture_graph",
                        lambda fn, device, pool=None: _ReplayEager(fn))
    cfg = taco.ACOConfig(iterations=5, use_pallas=True, seed=0, **kw)
    ns = (20, 14, 24, 9)
    insts = [ttsp.random_instance(n, seed=n) for n in ns]
    if kind == "sparse":
        b = tbatch.make_sparse_batch(insts, cfg.sparse_k, 32, device="cpu")
        init = lambda: teng.init_sparse_states(insts, cfg, [1, 2, 3, 4], 32,
                                               "cpu")
        ewt = b.ewt
    else:
        b = tbatch.make_batch(insts, 32, cfg.nn_k, device="cpu")
        init = lambda: teng.init_states(insts, cfg, [1, 2, 3, 4], 32,
                                        device="cpu")
        ewt = "EUC_2D"
    budgets = [3, 5, 4, 5]
    pc = tprog.ProgramCache()
    for donate in (False, True):
        pc.warm([32], 4, cfg, 5, donate=donate, kind=kind, device="cpu")
    assert [list(p.graphs) for p in pc._programs.values()] == [[None]] * 2
    for donate in (False, False, True, True):
        want = teng.run_batch(b.problem, init(), budgets, cfg, 5, kind=kind,
                              ewt=ewt)
        states = init()
        got = teng.run_batch(b.problem, states, budgets, cfg, 5, kind=kind,
                             ewt=ewt, donate=donate, programs=pc)
        if donate:
            assert got[0] is states
        for w, g in zip(want, got):
            for x, y in zip(_leaves(w), _leaves(g)):
                assert_bitwise(x, y)
    # (F, T, T, T) and (F, T, F, T) were seen in each program's first
    # call and captured at their second sight
    st = pc.stats()
    assert st["hits"] == 4 and st["misses"] == 0
    for sig in st["signatures"]:
        assert sig["patterns"] == ["all", "0111", "0101"]


def _leaves(x):
    from repro_torch import tree
    return tree.flatten(x)


def test_program_refuses_other_shapes(monkeypatch):
    """A call whose operands do not have the warmed shapes falls back to
    the engine's path with an ``aot_dispatch_fallback`` event."""
    monkeypatch.setattr(teng, "graph_route", lambda *a: True)
    monkeypatch.setattr(teng, "capture_graph",
                        lambda fn, device, pool=None: _ReplayEager(fn))
    cfg = taco.ACOConfig(iterations=2, use_pallas=True, variant="mmas")
    pc = tprog.ProgramCache()
    pc.warm([16], 2, cfg, 2, device="cpu")
    key, prog = next(iter(pc._programs.items()))
    insts = [ttsp.random_instance(10, seed=1)] * 2
    b = tbatch.make_batch(insts, 16, 8, device="cpu")        # nn_k 8, not 30
    st = teng.init_states(insts, cfg, [0, 1], 16, device="cpu")
    out = pc.call(teng._run_batch_local, b.problem, st, [2, 2], cfg, 2, 0,
                  None, None, kind="dense", ewt="EUC_2D", donate=False)
    want = teng.run_batch(b.problem, st, [2, 2], cfg, 2)
    assert_bitwise(out[0].best_len, want[0].best_len)
    kinds = [r["kind"] for r in pc.tel.events.records()]
    assert "aot_dispatch_fallback" in kinds
    assert pc.stats()["misses"] == 1 and pc.stats()["hits"] == 0


HOST_READS = ("_local_scalar_dense", "nonzero", "lift_fresh", "equal",
              "is_nonzero", "item")


@pytest.mark.parametrize("kw,kind", [
    (dict(variant="mmas", metrics=True), "dense"),
    (dict(variant="as", tau_dtype="int8"), "dense"),
    (dict(variant="acs", tau_dtype="bf16", metrics=True), "dense"),
    (dict(variant="mmas", sparse=True, sparse_k=6, m=8, metrics=True),
     "sparse"),
    (dict(variant="as", sparse=True, sparse_k=6, m=8, tau_dtype="int8"),
     "sparse"),
])
def test_graph_route_iteration_reads_nothing_from_the_device(kw, kind,
                                                              monkeypatch):
    """What a CUDA graph captures -- one engine iteration on a graph
    route, all slots active or not -- makes no host read of a device value
    and no host-to-device copy (``torch.tensor``): either would break the
    capture.  The kernels' plain versions, which stand for the launches
    here, are left out of the check."""
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import pheromone_update as pu
    from repro_torch.kernels import sparse_select as ss
    for mod, name in ((fs, "fused_walk_plain"),
                      (pu, "pheromone_update_tours_plain"),
                      (ss, "sparse_walk_plain")):
        def unchecked(*a, _fn=getattr(mod, name), **k):
            with _disable_current_modes():
                return _fn(*a, **k)
        monkeypatch.setattr(mod, name, unchecked)
    seen = []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in HOST_READS:
                seen.append(name)
            return func(*args, **(kwargs or {}))

    cfg = taco.ACOConfig(iterations=3, use_pallas=True, seed=0, **kw)
    insts = [ttsp.random_instance(n, seed=n) for n in (20, 14, 24)]
    if kind == "sparse":
        b = tbatch.make_sparse_batch(insts, cfg.sparse_k, 32, device="cpu")
        states = teng.init_sparse_states(insts, cfg, [1, 2, 3], 32, "cpu")
        ewt = b.ewt
    else:
        b = tbatch.make_batch(insts, 32, cfg.nn_k, device="cpu")
        states = teng.init_states(insts, cfg, [1, 2, 3], 32, device="cpu")
        ewt = "EUC_2D"
    assert teng.graph_route(b.problem, cfg, kind, "cuda")
    _, since, mets = teng._prepare(states, [3] * 3, cfg, None, None)
    step = teng.stack_step(b.problem, cfg, kind, ewt)
    n_act = taco.slot_n_actual(b.problem, "cpu")
    for flags in (None, (True, False, True)):
        idx = None if flags is None else teng.active_index(flags, "cpu")
        with HostReads():
            teng.stack_iteration(step, states, since, mets, flags, n_act,
                                 (), idx)
    assert not seen, seen
