"""Port parity for the paper's deposit ladder (Tables III/IV): every
strategy of repro_torch.core.pheromone against repro.core.pheromone.

The same seeded tours and weights go through the reference's
``deposit``/``update`` and the port's, at n = 40 and 70 (70 is not a
multiple of the tiles), tiles 0 (the default blocks), 16 and 64, the
one-hot deposit's chunk of 8 with m not a multiple of it, m = n and
m = 1, unpadded and padded (31 real cities of 40):

- a single deposit (one tour, MMAS/ACS) is bitwise in every strategy:
  each cell receives at most one term;
- a multi-ant (AS) deposit is held to the reference's contract, rtol 1e-5
  / atol 1e-7 (DESIGN.md §10).  Over these cases ``scatter``,
  ``reduction`` and ``onehot`` are bitwise (a chunk's index-order sum is
  XLA's dot order there); the reference's s2g blocks are XLA matmuls that
  sum a cell's terms in their own order, 2 ulp at most from the port's
  (``test_multi_ant_gap``).

``update`` is compared with the reference's jitted ``update``, as its
colony step runs it: XLA contracts ``(1 - rho) * tau + D`` into one fused
multiply-add, which the port rounds once too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import pheromone as jpher  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import pheromone as tpher  # noqa: E402
from torch_parity import assert_bitwise, ulp_distance  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)
STRATEGIES = ("scatter", "reduction", "s2g", "s2g_tiled", "onehot")


def _tours(n, m, n_actual, seed):
    """m seeded tours over the real cities (phantom tail in index order)
    and AS weights 1/C in the range of real tour lengths."""
    rng = np.random.default_rng(seed)
    real = n if n_actual is None else n_actual
    tours = np.stack([np.concatenate([rng.permutation(real),
                                      np.arange(real, n)])
                      for _ in range(m)]).astype(np.int32)
    w = (1.0 / (rng.random(m) * 4e3 + 1e3)).astype(np.float32)
    return tours, w


def _both(strategy, n, tours, w, tile, n_actual):
    na_j = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jpher.deposit(n, jnp.asarray(tours), jnp.asarray(w), strategy,
                         tile, na_j)
    got = tpher.deposit(n, torch.from_numpy(tours), torch.from_numpy(w),
                        strategy, tile, n_actual)
    return np.asarray(want), got


CASES = [(s, n, tile, na)
         for s in STRATEGIES
         for n, na in ((40, None), (70, None), (40, 31))
         for tile in ((0, 16, 64) if s == "s2g_tiled" else (64,))]


@pytest.mark.parametrize("strategy,n,tile,n_actual", CASES)
def test_single_deposit_bitwise(strategy, n, tile, n_actual):
    tours, w = _tours(n, 1, n_actual, seed=n)
    want, got = _both(strategy, n, tours, w, tile, n_actual)
    assert_bitwise(want, got, f"{strategy} deposit")


@pytest.mark.parametrize("strategy,n,tile,n_actual", CASES)
def test_multi_ant_deposit_close(strategy, n, tile, n_actual):
    """m = n ants: at n = 70 the one-hot deposit's last chunk of 8 is
    ragged (70 = 8 * 8 + 6), at n = 40 it is whole."""
    tours, w = _tours(n, n, n_actual, seed=n + 1)
    want, got = _both(strategy, n, tours, w, tile, n_actual)
    np.testing.assert_allclose(want, got.numpy(), **TOL)
    assert (got.numpy() == got.numpy().T).all()


@pytest.mark.parametrize("m", [1, 13, 40])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_update_is_the_reference(strategy, m):
    """``update``: ``(1 - rho) * tau + D`` rounded once, at rho 0.1 (at
    0.5 the product is exact); one tour bitwise, several within the
    contract."""
    n = 40
    tours, w = _tours(n, m, None, seed=m)
    tau = (np.random.default_rng(m).random((n, n)) * 1e-3).astype(np.float32)
    want = jax.jit(jpher.update, static_argnums=(3, 4, 5))(
        jnp.asarray(tau), jnp.asarray(tours), jnp.asarray(w), 0.1, strategy,
        16)
    got = tpher.update(torch.from_numpy(tau), torch.from_numpy(tours),
                       torch.from_numpy(w), 0.1, strategy, 16)
    if m == 1:
        assert_bitwise(want, got, f"{strategy} update")
    else:
        np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_multi_ant_gap():
    """The gap of a multi-ant deposit to the reference, in ulps of the
    cell: none for the scatters and the one-hot chunks, at most 2 for the
    s2g blocks (the largest seen over the cases above)."""
    for strategy, n, tile, n_actual in CASES:
        tours, w = _tours(n, n, n_actual, seed=n + 1)
        want, got = _both(strategy, n, tours, w, tile, n_actual)
        worst = int(ulp_distance(want, got).max())
        assert worst <= (2 if strategy.startswith("s2g") else 0), \
            (strategy, n, tile, n_actual, worst)


def test_strategies_and_errors():
    assert tpher.STRATEGIES == jpher.STRATEGIES
    tours, w = _tours(10, 2, None, seed=0)
    with pytest.raises(ValueError, match="unknown deposit strategy"):
        tpher.deposit(10, torch.from_numpy(tours), torch.from_numpy(w),
                      "nope")


@pytest.mark.parametrize("strategy", STRATEGIES[2:])
@pytest.mark.parametrize("variant", ["as", "mmas"])
def test_run_with_each_deposit_is_the_reference(strategy, variant):
    """``aco.run`` over 3 iterations: best tour and length bitwise, tau
    bitwise for MMAS (one tour) and within the contract for AS."""
    inst = jtsp.random_instance(26, seed=3)
    kw = dict(variant=variant, deposit=strategy, deposit_tile=16, m=12,
              iterations=3, rho=0.1)
    sj = jaco.run(inst, jaco.ACOConfig(**kw))
    st = taco.run(inst, taco.ACOConfig(**kw), device="cpu")
    assert_bitwise(sj.best_tour, st.best_tour, "best tour")
    assert_bitwise(sj.best_len, st.best_len, "best length")
    if variant == "mmas":
        assert_bitwise(sj.tau, st.tau, "tau")
    else:
        np.testing.assert_allclose(np.asarray(sj.tau), st.tau.numpy(), **TOL)
