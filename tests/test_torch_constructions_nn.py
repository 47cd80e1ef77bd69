"""Port parity for the paper's NN-list constructions (Table II's v4):
``nn_list`` and ``nn_list_eager`` of repro_torch.core.strategies against
repro.core.strategies, on the grid and operands of
tests/test_torch_constructions.py (n = 40, m = 20, nn_k = 10, unpadded and
padded, tours and lengths bitwise but for gumbel's near-ties), and the
lazy fallback bitwise the eager one.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sampling, strategies  # noqa: E402
from test_torch_constructions import M, _operands  # noqa: E402
from test_torch_constructions import cases, check_construction  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402


@pytest.mark.parametrize("method,selection,draw_mode,n_actual",
                         cases(("nn_list", "nn_list_eager")))
def test_nn_construction_is_the_reference(method, selection, draw_mode,
                                          n_actual):
    check_construction(method, selection, draw_mode, n_actual)


@pytest.mark.parametrize("selection", ["iroulette", "roulette", "greedy"])
@pytest.mark.parametrize("n_actual", [None, 31])
def test_lazy_nn_list_is_the_eager_one(selection, n_actual):
    """The fallback is only read where no candidate is left, so computing
    it on every step changes nothing; a short list (k = 3) makes the
    fallback run on most steps."""
    _, port = _operands(n_actual, seed=9)
    nn3 = port["nn"][:, :3].contiguous()
    out = [strategies.construct_tours(
        sampling.prng_key(1), port["dist"], port["choice"], M,
        method=method, selection=selection, nn=nn3, n_actual=n_actual)
        for method in ("nn_list", "nn_list_eager")]
    assert_bitwise(out[0].tours, out[1].tours, "tours")
    assert_bitwise(out[0].lengths, out[1].lengths, "lengths")
