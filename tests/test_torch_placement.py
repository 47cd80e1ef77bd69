"""Port parity for the ACO layer-placement solver: repro_torch.core.placement
against repro.core.placement.

The same problem (log-normal layer costs from a seeded NumPy generator, as
tests/test_system.py draws them) and the same seed go through both:

- ``assignment_cost`` and ``uniform_baseline`` bitwise;
- one ``_step`` from the same tau and key: the assignment, tau and the
  best cost bitwise, also at 61 layers and 64 ants, where the reference's
  one-hot ``einsum``s are XLA CPU dots that vectorise their sums
  (``floatops.xla_dot_sum``);
- ``solve``: the reference's best assignment and cost.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import placement as jp  # noqa: E402
from repro_torch.core import placement as tp  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402


def _problem(n_layers, n_stages, seed, traffic=None, lam=0.02):
    rng = np.random.RandomState(seed)
    costs = tuple(np.exp(rng.normal(0, 1.0, size=n_layers)) * 10)
    traffic = (1.0,) * n_layers if traffic is None else traffic
    kw = dict(layer_costs=costs, edge_traffic=traffic, n_stages=n_stages,
              comm_lambda=lam)
    return jp.PlacementProblem(**kw), tp.PlacementProblem(**kw)


def _traffic(n_layers, seed):
    return tuple(np.random.default_rng(seed).random(n_layers) * 3)


# (layers, stages, seed, ants, traffic seed or None)
STEP_CASES = [(32, 4, 1, 32, None), (24, 3, 5, 16, 2), (61, 8, 7, 64, 3)]


@pytest.mark.parametrize("n_layers,n_stages,seed,ants,tseed", STEP_CASES)
def test_costs_are_the_reference(n_layers, n_stages, seed, ants, tseed):
    traffic = None if tseed is None else _traffic(n_layers, tseed)
    pj, pt = _problem(n_layers, n_stages, seed, traffic)
    assign = np.random.default_rng(seed).integers(
        0, n_stages, (ants, n_layers)).astype(np.int32)
    want = jp.assignment_cost(pj, jnp.asarray(assign))
    got = tp.assignment_cost(pt, torch.from_numpy(assign))
    assert_bitwise(want, got, "assignment_cost")
    a_j, c_j = jp.uniform_baseline(pj)
    a_t, c_t = tp.uniform_baseline(pt)
    assert_bitwise(a_j, a_t, "uniform assignment")
    assert np.float32(c_j) == np.float32(c_t)


@pytest.mark.parametrize("n_layers,n_stages,seed,ants,tseed", STEP_CASES)
def test_one_step_is_the_reference(n_layers, n_stages, seed, ants, tseed):
    traffic = None if tseed is None else _traffic(n_layers, tseed)
    pj, pt = _problem(n_layers, n_stages, seed, traffic)
    cfg = dict(ants=ants, iterations=3, seed=seed)
    rng = np.random.default_rng(seed)
    tau = (0.5 + rng.random((n_layers, n_stages))).astype(np.float32)
    key_j = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    key_t = sampling.fold_in(sampling.prng_key(seed), 2)
    tj, aj, cj = jp._step(jnp.asarray(tau), key_j, pj,
                          jp.PlacementConfig(**cfg))
    tt, at, ct = tp._step(torch.from_numpy(tau), key_t, pt,
                          tp.PlacementConfig(**cfg))
    assert_bitwise(aj, at, "best assignment")
    assert_bitwise(tj, tt, "tau")
    assert_bitwise(cj, ct, "best cost")


@pytest.mark.parametrize("m", [7, 10, 32, 50, 64])
def test_quantile_is_the_reference(m):
    x = (np.random.default_rng(m).random(m) * 300).astype(np.float32)
    want = jax.jit(lambda x: jnp.quantile(x, 0.25))(x)
    assert_bitwise(want, tp._quantile(torch.from_numpy(x), 0.25),
                   f"quantile m={m}")


@pytest.mark.parametrize("n_layers,n_stages,seed,ants,iters",
                         [(32, 4, 1, 32, 40), (24, 3, 5, 16, 20)])
def test_solve_is_the_reference(n_layers, n_stages, seed, ants, iters):
    pj, pt = _problem(n_layers, n_stages, seed)
    cfg = dict(ants=ants, iterations=iters, seed=0)
    a_j, c_j = jp.solve(pj, jp.PlacementConfig(**cfg))
    a_t, c_t = tp.solve(pt, tp.PlacementConfig(**cfg), device="cpu")
    assert isinstance(a_t, np.ndarray) and isinstance(c_t, float)
    assert_bitwise(a_j, a_t, "best assignment")
    assert np.float32(c_j) == np.float32(c_t)


def test_placement_engine_beats_uniform_on_heterogeneous():
    """The counterpart of tests/test_system.py::
    test_placement_engine_beats_uniform_on_heterogeneous."""
    rng = np.random.RandomState(1)
    costs = np.exp(rng.normal(0, 1.0, size=32)) * 10
    prob = tp.PlacementProblem(
        layer_costs=tuple(costs), edge_traffic=(1.0,) * 32, n_stages=4,
        comm_lambda=0.02)
    _, uni = tp.uniform_baseline(prob)
    _, ours = tp.solve(prob, tp.PlacementConfig(ants=32, iterations=40,
                                                seed=0), device="cpu")
    assert ours < uni


def test_solve_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: solve runs there by default")
    _, pt = _problem(8, 2, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.solve(pt, tp.PlacementConfig(ants=4, iterations=1))
