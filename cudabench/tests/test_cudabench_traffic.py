"""The traffic is a function of the seed, and every seed offers the same
work."""
import numpy as np

from cudabench import cells
from cudabench.cells import HERE

poisson = cells.load_module(HERE / "traffic" / "poisson.py")
colony = cells.load_module(HERE / "traffic" / "colony_loop.py")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["due"] == y["due"] and x["n"] == y["n"]
        assert x["seed"] == y["seed"] and x["kind"] == y["kind"]
        np.testing.assert_array_equal(x["coords"], y["coords"])


def test_poisson_schedule_repeats_for_a_seed():
    seed = 2**31 + 77
    _same(poisson.schedule(seed, 8.0, 5.0, 520, 1024, 1000.0),
          poisson.schedule(seed, 8.0, 5.0, 520, 1024, 1000.0))


def test_poisson_seeds_share_gaps_and_sizes():
    a = poisson.schedule(1, 8.0, 30.0, 520, 1024, 1000.0)
    b = poisson.schedule(2**33 + 5, 8.0, 30.0, 520, 1024, 1000.0)
    assert len(a) == len(b) == 240
    gaps = [np.diff([0.0] + [x["due"] for x in s]) for s in (a, b)]
    np.testing.assert_allclose(np.sort(gaps[0]), np.sort(gaps[1]),
                               rtol=1e-9, atol=1e-12)
    assert sorted(x["n"] for x in a) == sorted(x["n"] for x in b)
    assert [x["n"] for x in a] != [x["n"] for x in b]
    assert all(x["due"] < 30.0 for x in a)
    assert min(x["n"] for x in a) >= 520 and max(x["n"] for x in a) <= 1024
    assert [x["kind"] for x in a[:4]] == ["circle", "random"] * 2


def test_warmup_stream_differs_from_the_window():
    a = poisson.schedule(9, 8.0, 3.0, 520, 1024, 1000.0)
    b = poisson.schedule(9, 8.0, 3.0, 520, 1024, 1000.0,
                         poisson.WARMUP_STREAM)
    assert {x["seed"] for x in a}.isdisjoint({x["seed"] for x in b})


def test_colony_coordinates_repeat_for_a_seed():
    a = colony.coordinates(2**31 + 3, 50, 1000.0)
    np.testing.assert_array_equal(a, colony.coordinates(2**31 + 3, 50,
                                                        1000.0))
    assert not np.array_equal(a, colony.coordinates(4, 50, 1000.0))
