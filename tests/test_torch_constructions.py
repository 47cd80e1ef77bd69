"""Port parity for the paper's construction ladder (Table II): the
``task_baseline``, ``task_choice``, ``nn_list`` and ``nn_list_eager``
constructions of repro_torch.core.strategies against repro.core.strategies.

The same seeded instance, tau, key and candidate lists go through the
reference's ``construct_tours`` and the port's, at n = 40, m = 20, nn_k =
10, unpadded and padded (31 real cities of 40): tours and lengths bitwise
for every selection but ``gumbel``, whose ``torch.log`` is an ulp off
XLA's (held as ``test_torch_sampling.py`` holds the gumbel selector: a
differing pick only between candidates whose reference scores lie within
4 ulp); the ``nn_list`` pair's grid is in
tests/test_torch_constructions_nn.py.  ``roulette`` sums its CDF in XLA's scan order
(``floatops.xla_cumsum``) and ``task_baseline``'s traced power is the C
library's ``powf`` (``floatops.powf``); both are held here and in
``test_roulette_and_power_follow_the_reference``.  Whole colonies with
these constructions: tests/test_torch_constructions_colony.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import strategies as jstr  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import floatops, sampling, strategies  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from torch_parity import assert_bitwise, ulp_distance  # noqa: E402

LADDER = ("task_baseline", "task_choice", "nn_list", "nn_list_eager")
N, M, K = 40, 20, 10


def _operands(n_actual, seed=2):
    """(reference problem pieces, port pieces) of one seeded instance:
    dist, eta, nn, a perturbed tau and its choice matrix."""
    inst = jtsp.random_instance(N if n_actual is None else n_actual,
                                seed=seed)
    if n_actual is not None:
        inst = jtsp.pad_instance(inst, N)
    pj = jaco.make_problem(inst, K)
    rng = np.random.default_rng(seed)
    tau = (rng.random((N, N)) * 1e-2 + 1e-3).astype(np.float32)
    ref = dict(dist=pj.dist, eta=pj.eta, nn=pj.nn, tau=jnp.asarray(tau))
    port = {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in ref.items()}
    ref["choice"] = jstr.choice_matrix(ref["tau"], ref["eta"], 1.0, 2.0)
    port["choice"] = strategies.choice_matrix(port["tau"], port["eta"],
                                              1.0, 2.0)
    return ref, port


def _gumbel_scores(choice, tours, t, a, visited, key, draw_mode):
    """The reference's gumbel scores of ant ``a`` at step ``t``."""
    w = np.asarray(choice)[tours[a, t - 1]] * ~visited
    k = jax.random.fold_in(key, t)
    g = np.asarray(jsamp.counter_gumbel(k, (M, N)) if draw_mode == "counter"
                   else jax.random.gumbel(k, (M, N)))[a]
    return np.where(w > 0, np.log(np.maximum(w, 1e-38)), -1e30) + g


def cases(methods):
    """(method, selection, draw mode, n_actual) over ``methods``; roulette
    and greedy draw no per-city bits, so only packed draws for them."""
    return [(method, sel, dm, na)
            for method in methods
            for sel in ("iroulette", "roulette", "greedy", "gumbel")
            for dm in ("packed", "counter")
            for na in (None, 31)
            if not (dm == "counter" and sel in ("roulette", "greedy"))]


def check_construction(method, selection, draw_mode, n_actual):
    """The port's ``construct_tours`` against the reference's on the same
    operands and key (the grid's one case)."""
    ref, port = _operands(n_actual)
    kj, kt = jax.random.PRNGKey(5), sampling.prng_key(5)
    want = jstr.construct_tours(
        kj, ref["dist"], ref["choice"], M, method=method,
        selection=selection, nn=ref["nn"], tau=ref["tau"], eta=ref["eta"],
        n_actual=None if n_actual is None else jnp.asarray(n_actual,
                                                           jnp.int32),
        draw_mode=draw_mode)
    got = strategies.construct_tours(
        kt, port["dist"], port["choice"], M, method=method,
        selection=selection, nn=port["nn"], tau=port["tau"],
        eta=port["eta"], n_actual=n_actual, draw_mode=draw_mode)
    real = N if n_actual is None else n_actual
    for tour in got.tours.numpy():
        assert ttsp.is_valid_tour(tour[:real])
        assert (tour[real:] == np.arange(real, N)).all()
    uses_gumbel = selection == "gumbel" and method != "task_baseline"
    if not uses_gumbel:
        assert_bitwise(want.tours, got.tours, "tours")
        assert_bitwise(want.lengths, got.lengths, "lengths")
        return
    # gumbel: the first step where the two differ must be a near-tie
    wt, gt = np.asarray(want.tours), got.tours.numpy()
    assert (wt[:, 0] == gt[:, 0]).all()
    for a in np.nonzero((wt != gt).any(1))[0]:
        t = int(np.argmax(wt[a] != gt[a]))
        visited = np.zeros(N, bool)
        visited[wt[a, :t]] = True
        k2 = jax.random.split(kj)[1]
        s = _gumbel_scores(ref["choice"], wt, t, a, visited, k2,
                           draw_mode).astype(np.float32)
        assert ulp_distance(s[wt[a, t]], s[gt[a, t]]) <= 4, (a, t)


@pytest.mark.parametrize("method,selection,draw_mode,n_actual",
                         cases(("task_baseline", "task_choice")))
def test_construction_is_the_reference(method, selection, draw_mode,
                                       n_actual):
    check_construction(method, selection, draw_mode, n_actual)


@pytest.mark.parametrize("method", ["data_parallel", "task_choice",
                                    "task_baseline", "nn_list"])
def test_construction_yields_valid_tours(method):
    """The counterpart of tests/test_core.py::
    test_construction_yields_valid_tours."""
    inst = ttsp.random_instance(40, seed=3)
    prob = taco.make_problem(inst, nn_k=10, device="cpu")
    tau = torch.ones((40, 40))
    ci = strategies.choice_matrix(tau, prob.eta, 1.0, 2.0)
    res = strategies.construct_tours(
        sampling.fold_in(sampling.prng_key(7), 1), prob.dist, ci, 20,
        method=method, nn=prob.nn, tau=tau, eta=prob.eta)
    tours = res.tours.numpy()
    assert tours.shape == (20, 40)
    assert ttsp.is_valid_tour(tours)
    d = prob.dist.numpy()
    for k in range(20):
        np.testing.assert_allclose(
            res.lengths[k].item(), d[tours[k], np.roll(tours[k], -1)].sum(),
            rtol=1e-5)


def test_roulette_and_power_follow_the_reference():
    """The two reference numerics the ladder rests on, at widths where
    they matter: XLA's CPU cumsum (blocks of 16, then the blocks' totals)
    and its traced power (the C library's powf)."""
    rng = np.random.default_rng(0)
    for n in (17, 40, 64, 100, 300, 1002):
        w = (rng.random((6, n)) ** 3).astype(np.float32)
        w[rng.random((6, n)) < 0.3] = 0.0
        want = jax.jit(lambda x: jnp.cumsum(x, axis=-1))(w)
        assert_bitwise(want, floatops.xla_cumsum(torch.from_numpy(w)),
                       f"cumsum n={n}")
        kj, kt = jax.random.PRNGKey(n), sampling.prng_key(n)
        assert_bitwise(jax.jit(jsamp.roulette)(kj, w),
                       sampling.roulette(kt, torch.from_numpy(w)),
                       f"roulette n={n}")
    x = np.concatenate([rng.random(3000) * 1e-2,
                        1.0 / (rng.random(3000) * 100 + 1)]).astype(
                            np.float32)
    for p in (1.0, 2.0, 3.0, 0.5):
        want = jax.jit(lambda x, p: x ** p)(x, np.float32(p))
        got = floatops.powf(torch.from_numpy(x),
                            torch.tensor(np.float32(p)))
        assert_bitwise(want, got, f"pow {p}")


def test_construct_tours_rejects_a_stack_and_unknown_methods():
    _, port = _operands(None)
    keys = torch.stack([sampling.prng_key(1), sampling.prng_key(2)])
    for method in LADDER:
        with pytest.raises(ValueError, match="takes one instance"):
            strategies.construct_tours(keys, port["dist"][None],
                                       port["choice"][None], M,
                                       method=method, nn=port["nn"])
    with pytest.raises(ValueError, match="unknown construction"):
        strategies.construct_tours(sampling.prng_key(1), port["dist"],
                                   port["choice"], M, method="nope")
    assert set(strategies.METHODS) == {
        "data_parallel", "task_choice", "task_baseline", "nn_list",
        "nn_list_eager", "pallas", "fused"}
