"""The plain reference against the port's CPU route (its kernels' plain
versions), bitwise: one colony, and padded colonies served by the
streaming service."""
import numpy as np
import pytest
import torch

from cudabench.reference import aco as ref
from repro_torch.core import aco, tsp
from repro_torch.solver.streaming import StreamingSolverService


@pytest.mark.parametrize("k, spare", [(32, 64), (2, 64), (2, 1)])
def test_reference_follows_a_colony(k, spare):
    n, seed = 40, 2**31 + 11
    xy = np.random.default_rng(5).uniform(0, 1000, (n, 2))
    inst = tsp.TSPInstance("u", coords=xy, edge_weight_type="EUC_2D")
    cfg = aco.ACOConfig(variant="as", use_pallas=True)
    prob = aco.make_problem(inst, 30, "cpu")
    st = aco.init_colony(inst, cfg, seed=seed, device="cpu")
    d = ref.distances(xy, "EUC_2D")
    np.testing.assert_array_equal(d, inst.distances())
    col = ref.make_colony([d], n, n, "cpu")
    rs = ref.initial_state([d], n, [seed], [n], "cpu")
    assert torch.equal(st.tau, rs.tau[0])
    for _ in range(3):
        st, it_best = aco.colony_step(prob, st, cfg)
        rs, rit, _ = ref.iterate(col, rs, k=k, spare=spare)
        assert torch.equal(st.tau, rs.tau[0])
        assert torch.equal(st.best_tour.long(), rs.best_tour[0])
        assert torch.equal(st.key, rs.key[0])
        assert float(it_best) == float(rit[0])


def test_reference_follows_the_stream():
    cfg = aco.ACOConfig(variant="as", use_pallas=True, iterations=4)
    svc = StreamingSolverService(cfg, max_batch=3, chunk=2, device="cpu")
    rng = np.random.default_rng(3)
    xys, seeds = [], []
    for i in range(4):
        n = int(rng.integers(17, 33))
        xys.append(rng.uniform(0, 1000, (n, 2)))
        seeds.append(2**33 + i)
        svc.submit(tsp.TSPInstance(f"r{i}", coords=xys[-1],
                                   edge_weight_type="RAW"),
                   iterations=4, seed=seeds[-1])
    got = sorted(svc.run_until_drained(), key=lambda r: r.request_id)
    dists = [ref.distances(xy, "RAW") for xy in xys]
    col = ref.make_colony(dists, 32, 32, "cpu")
    st = ref.initial_state(dists, 32, seeds, [d.shape[0] for d in dists],
                           "cpu")
    want = ref.run(col, st, 4, k=3)
    for i, r in enumerate(got):
        n = xys[i].shape[0]
        np.testing.assert_array_equal(r.best_tour,
                                      want.best_tour[i, :n].numpy())
        assert np.float32(r.best_len) == want.best_len[i].numpy()


def test_bfloat16_weights_change_the_tours():
    n = 120
    xy = np.random.default_rng(6).uniform(0, 1000, (n, 2))
    d = ref.distances(xy, "EUC_2D")
    col = ref.make_colony([d], n, n, "cpu")
    st = ref.initial_state([d], n, [1], [n], "cpu")
    a = ref.iterate(col, st)[2]
    b = ref.iterate(col, st, weight_dtype=torch.bfloat16)[2]
    assert not torch.equal(a, b)
