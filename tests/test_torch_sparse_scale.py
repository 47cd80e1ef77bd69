"""Port parity for the sparse route at the shapes it runs at: one
``sparse_colony_step`` of repro_torch.sparse against repro.sparse at
n = 1002 / 2392, k = 16 (+ 4 overflow slots), m = 64, the configuration
of benchmarks/sparse_scale.py, on the kernel route (plain versions here).

The port's bitwise parity at small sizes rests on rewrites XLA picks by
shape (the scatter-or-addcmul update, the 32-wide reduction tree, the
correctly rounded root); this file holds them at the route's own shapes.
Both sides start the compared step from the reference's state after one
iteration (through ``convert``), so overflow pages are already in use.
Tours, best_len, tau, tau_def, overflow pages and key: bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.sparse import aco as jsa  # noqa: E402
from repro.sparse import store as jst  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.sparse import aco as tsa  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

K = 16


def _state_to_port(sj):
    return convert.sparse_state_from_numpy(
        *[tuple(np.asarray(y) for y in x) if isinstance(x, tuple)
          else np.asarray(x) for x in sj], device="cpu")


@pytest.mark.parametrize("n,variant,construction", [
    (2392, "mmas", "data_parallel"),
    (1002, "as", "data_parallel"),
    (1002, "acs", "data_parallel"),
    (2392, "mmas", "partial"),
])
def test_sparse_step_at_route_shape_bitwise(n, variant, construction):
    inst = jtsp.random_instance(n, seed=n)
    kw = dict(variant=variant, selection="iroulette",
              construction=construction, use_pallas=True, sparse=True,
              sparse_k=K, m=64, seed=0, partial_window=64)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jst.make_sparse_problem(inst, K)
    pt = convert.sparse_problem_from_numpy(
        **{f: np.asarray(getattr(pj, f))
           for f in ("coords", "cand", "cand_dist", "cand_eta")},
        device="cpu")
    sj, _ = jsa.sparse_colony_step(pj, jsa.init_sparse_colony(inst, cj), cj,
                                   "RAW")
    st = _state_to_port(sj)
    sj, bj = jsa.sparse_colony_step(pj, sj, cj, "RAW")
    st, bt = tsa.sparse_colony_step(pt, st, ct, "RAW")
    assert_bitwise(bj, bt, "it_best")
    for f in ("best_tour", "best_len", "tau", "tau_def", "ovf_city",
              "ovf_tau", "iteration"):
        assert_bitwise(getattr(sj, f), getattr(st, f), f)
    assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key, "key")
    if variant == "mmas" and construction == "data_parallel":
        assert (np.asarray(sj.ovf_city) >= 0).any()     # adoption happened
