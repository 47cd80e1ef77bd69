"""Port parity: repro_torch.core.tsp against repro.core.tsp, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tsp as jtsp  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

INSTANCES = {
    "circle31": lambda m: m.circle_instance(31, seed=2),
    "grid6": lambda m: m.grid_instance(6),
    "rand29": lambda m: m.random_instance(29, seed=4),
}

TSPLIB = """NAME : tiny5
TYPE : TSP
DIMENSION : 5
EDGE_WEIGHT_TYPE : ATT
NODE_COORD_SECTION
1 6734 1453
2 2233 10
3 5530 1424
4 401 841
5 3082 1644
EOF
"""


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_numpy_half_identical(name):
    ij, it = INSTANCES[name](jtsp), INSTANCES[name](ttsp)
    assert_bitwise(ij.distances(), it.distances(), "distances")
    assert ij.known_optimum == it.known_optimum
    tj, lj = jtsp.nearest_neighbour_tour(ij.distances(), start=3)
    tt, lt = ttsp.nearest_neighbour_tour(it.distances(), start=3)
    assert_bitwise(tj, tt, "nn tour") and lj == lt
    pj, pt = jtsp.pad_instance(ij, 40), ttsp.pad_instance(it, 40)
    assert_bitwise(pj.distances(), pt.distances(), "padded distances")


def test_tsplib_parser_identical():
    a, b = jtsp.parse_tsplib(TSPLIB), ttsp.parse_tsplib(TSPLIB)
    assert a.name == b.name == "tiny5" and a.edge_weight_type == "ATT"
    assert_bitwise(a.distances(), b.distances(), "ATT distances")
    with pytest.raises(ValueError, match="EDGE_WEIGHT_TYPE"):
        ttsp.parse_tsplib(TSPLIB.replace("ATT", "GEO"))


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("k", [4, 10, 100])
def test_nn_lists_bitwise(name, k):
    d = INSTANCES[name](jtsp).distances()
    assert_bitwise(jtsp.nn_lists(jnp.asarray(d), k),
                   ttsp.nn_lists(torch.tensor(d), k), "nn_lists")


@pytest.mark.parametrize("k", [5, 30])
def test_nn_lists_masked_bitwise(k):
    inst = jtsp.pad_instance(jtsp.grid_instance(5), 32)
    d = inst.distances()
    assert_bitwise(jtsp.nn_lists(jnp.asarray(d), k, n_actual=25),
                   ttsp.nn_lists(torch.tensor(d), k, n_actual=25),
                   "masked nn_lists")


@pytest.mark.parametrize("width", [1, 2, 7, 8, 29, 64, 73])
def test_edge_sum_bitwise(width):
    x = np.random.default_rng(width).random((5, width)).astype(np.float32)
    x *= 1000.0
    assert_bitwise(jtsp.edge_sum(jnp.asarray(x)),
                   ttsp.edge_sum(torch.tensor(x)), "edge_sum")


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_tour_length_and_heuristic_bitwise(name):
    d = INSTANCES[name](jtsp).distances()
    n = d.shape[0]
    rng = np.random.default_rng(1)
    tours = np.stack([rng.permutation(n) for _ in range(6)]).astype(np.int32)
    assert_bitwise(jtsp.tour_length(jnp.asarray(d), jnp.asarray(tours)),
                   ttsp.tour_length(torch.tensor(d), torch.tensor(tours)),
                   "tour_length")
    assert_bitwise(jtsp.heuristic_matrix(jnp.asarray(d)),
                   ttsp.heuristic_matrix(torch.tensor(d)), "eta")


def test_masked_tour_length_and_heuristic_bitwise():
    inst = jtsp.pad_instance(jtsp.random_instance(23, seed=8), 30)
    d = inst.distances()
    rng = np.random.default_rng(2)
    tours = np.stack([np.concatenate([rng.permutation(23), np.arange(23, 30)])
                      for _ in range(5)]).astype(np.int32)
    want = jtsp.tour_length(jnp.asarray(d), jnp.asarray(tours),
                            jnp.asarray(23, jnp.int32))
    got = ttsp.tour_length(torch.tensor(d), torch.tensor(tours), 23)
    assert_bitwise(want, got, "masked tour_length")
    assert np.isfinite(np.asarray(want)).all()
    assert_bitwise(jtsp.heuristic_matrix(jnp.asarray(d)),
                   ttsp.heuristic_matrix(torch.tensor(d)), "padded eta")
