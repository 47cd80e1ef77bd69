"""Port parity for local search: repro_torch's ``two_opt_best`` plain version,
``core.localsearch`` and the colony step with ``local_search`` against the
JAX package.

Contracts:

- ``two_opt_best`` plain vs the Pallas kernel (interpret mode; m not a
  multiple of its 8-ant block, M not a multiple of its 512-move tile, a
  fully masked row, tied deltas) and ``select_move`` vs the reference's:
  delta and index bitwise, the 1e30 / 2**31 - 1 sentinels included;
- ``improve_with_lengths``: tours and lengths bitwise, for every
  strategy, both move rules, masked and unmasked, either reduction;
- ``colony_step``/``run`` with local search: the pure route bitwise
  against the JAX pure route (tau included); the kernel route's tours and
  lengths bitwise against the JAX kernel route, tau under the contract of
  tests/test_torch_aco.py (bitwise for MMAS and ACS at rho 0.5, AS
  rtol 1e-5 / atol 1e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import localsearch as jls  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import two_opt as jto  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import localsearch as tls  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import two_opt as to  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402


def _operands(m, M, seed, masked_row=None, ties=False):
    rng = np.random.default_rng(seed)
    ops_ = [(rng.random((m, M)) * 100).astype(np.float32) for _ in range(4)]
    if ties:   # coarse values: many equal deltas, the tie rule decides
        ops_ = [np.round(x / 25).astype(np.float32) * 25 for x in ops_]
    valid = rng.random((m, M)) < 0.7
    if masked_row is not None:
        valid[masked_row] = False
    return ops_, valid


@pytest.mark.parametrize("mode", ["best", "first"])
@pytest.mark.parametrize("m,M,ties", [(13, 1100, False), (5, 700, True),
                                      (9, 96, False)])
def test_two_opt_best_plain_vs_pallas(mode, m, M, ties):
    (a1, a2, r1, r2), valid = _operands(m, M, m * M, masked_row=2, ties=ties)
    thr = 1e-3 if mode == "first" else 0.0
    want = jto.two_opt_best(a1, a2, r1, r2, valid, thr=thr, mode=mode,
                            interpret=True)
    T = [torch.tensor(x) for x in (a1, a2, r1, r2, valid)]
    got = to.two_opt_best_plain(*T, thr=thr, mode=mode)
    assert_bitwise(want[0], got[0], "delta")
    assert_bitwise(want[1], got[1], "index")
    sentinel_idx = 0 if mode == "best" else 2**31 - 1
    assert got[0][2].item() == np.float32(1e30)
    assert got[1][2].item() == sentinel_idx
    # ops on CPU tensors is the plain version, and launches nothing
    ops.reset_launch_counts()
    again = ops.two_opt_best(*T, thr=thr, mode=mode)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert ops.launch_counts()["two_opt_best"] == 0


@pytest.mark.parametrize("mode", ["best", "first"])
def test_select_move_vs_reference(mode):
    rng = np.random.default_rng(3)
    delta = (rng.standard_normal((7, 50)) * 3).round().astype(np.float32)
    valid = rng.random((7, 50)) < 0.5
    valid[4] = False
    delta[6] = 5.0         # nothing improves in row 6
    want = jref.select_move(delta, valid, thr=0.5, mode=mode)
    got = ref.select_move(torch.tensor(delta), torch.tensor(valid), thr=0.5,
                          mode=mode)
    assert_bitwise(want[0], got[0], "delta")
    assert_bitwise(want[1], got[1], "index")
    assert ref.two_opt_best is to.two_opt_best_plain


def test_positions_and_successors():
    rng = np.random.default_rng(1)
    tours = np.stack([np.concatenate([rng.permutation(9), np.arange(9, 12)])
                      for _ in range(4)]).astype(np.int32)
    assert_bitwise(jls.tour_positions(jnp.asarray(tours)),
                   tls.tour_positions(torch.tensor(tours)), "positions")
    for n_act in (None, 9):
        assert_bitwise(jls._successors(jnp.asarray(tours), n_act),
                       tls._successors(torch.tensor(tours), n_act),
                       f"successors n_actual={n_act}")


def _problems(inst, nn_k, n_actual=None):
    pj = jaco.make_problem(inst, nn_k)
    pt = taco.make_problem(inst, nn_k, device="cpu")
    if n_actual is not None:
        pj = pj._replace(n_actual=jnp.asarray(n_actual, jnp.int32))
        pt = pt._replace(n_actual=n_actual)
    return pj, pt


# (kind, improvement, masked, use_pallas): every strategy under both move
# rules, each masked and unmasked and through either reduction.
IMPROVE_CASES = [
    ("2opt", "best", False, True), ("2opt", "first", True, False),
    ("oropt", "best", True, False), ("oropt", "first", False, False),
    ("2opt_oropt", "best", True, True), ("2opt_oropt", "first", False, True),
]


@pytest.mark.parametrize("kind,improvement,masked,use_pallas", IMPROVE_CASES)
def test_improve_with_lengths_bitwise(kind, improvement, masked, use_pallas):
    n_real = 37
    inst = jtsp.random_instance(n_real, seed=11)
    n_act = None
    if masked:
        inst, n_act = jtsp.pad_instance(inst, 44), n_real
    pj, pt = _problems(inst, 8, n_act)
    rng = np.random.default_rng(5)
    n = inst.n
    tours = np.stack([np.concatenate([rng.permutation(n_real),
                                      np.arange(n_real, n)])
                      for _ in range(6)]).astype(np.int32)
    kw = dict(kind=kind, improvement=improvement, use_pallas=use_pallas,
              rounds=12)
    want = jls.improve_with_lengths(pj.dist, pj.nn, jnp.asarray(tours),
                                    jls.LocalSearchConfig(**kw), pj.n_actual)
    ops.reset_launch_counts()
    tls.improve.rounds = 0
    got = tls.improve_with_lengths(pt.dist, pt.nn, torch.tensor(tours),
                                   tls.LocalSearchConfig(**kw), n_act)
    assert_bitwise(want[0], got[0], "tours")
    assert_bitwise(want[1], got[1], "lengths")
    assert 1 <= tls.improve.rounds <= 12
    assert ops.launch_counts()["two_opt_best"] == 0
    if masked:   # the phantom tail is never touched
        assert (got[0][:, n_real:] == torch.arange(n_real, n)).all()


def test_improve_exit_rule_and_never_worse():
    inst = jtsp.circle_instance(24, seed=1)
    _, pt = _problems(inst, 6)
    tours = torch.stack([torch.randperm(24, generator=torch.Generator()
                                        .manual_seed(s)) for s in range(5)])
    tours = tours.to(torch.int32)
    base = ttsp.tour_length(pt.dist, tours)
    cfg = tls.LocalSearchConfig(kind="2opt_oropt", rounds=200)
    tls.improve.rounds = 0
    out, lengths = tls.improve_with_lengths(pt.dist, pt.nn, tours, cfg)
    rounds = tls.improve.rounds
    assert rounds < 200                       # stopped once nothing changed
    assert (lengths <= base).all()
    assert torch.equal(tls.improve(pt.dist, pt.nn, out, cfg), out)
    assert tls.improve.rounds == rounds + 1   # one round that changed nothing
    none = tls.LocalSearchConfig(kind="none")
    assert tls.improve(pt.dist, pt.nn, tours, none) is tours
    with pytest.raises(ValueError, match="unknown local-search strategy"):
        tls.improve(pt.dist, pt.nn, tours, tls.LocalSearchConfig(kind="3opt"))


def _assert_state(sj, st, tau_exact, what):
    assert_bitwise(sj.best_tour, st.best_tour, f"{what} best_tour")
    assert_bitwise(sj.best_len, st.best_len, f"{what} best_len")
    assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key, f"{what} key")
    if tau_exact:
        assert_bitwise(sj.tau, st.tau, f"{what} tau")
    else:
        np.testing.assert_allclose(np.asarray(sj.tau), st.tau.numpy(),
                                   rtol=1e-5, atol=1e-7)


# (variant, local_search, ls_tours, ls_every, improvement, use_pallas, rho)
STEP_CASES = [
    ("as", "2opt", "all", 1, "best", False, 0.1),
    ("mmas", "2opt_oropt", "iteration_best", 2, "best", False, 0.1),
    ("acs", "oropt", "all", 2, "first", False, 0.5),
    ("mmas", "2opt", "all", 1, "best", True, 0.5),
    ("as", "2opt_oropt", "iteration_best", 1, "first", True, 0.5),
    ("acs", "2opt", "iteration_best", 2, "best", True, 0.5),
]


@pytest.mark.parametrize(
    "variant,local_search,ls_tours,ls_every,improvement,use_pallas,rho",
    STEP_CASES)
def test_colony_step_with_local_search_vs_jax(variant, local_search,
                                              ls_tours, ls_every,
                                              improvement, use_pallas, rho):
    inst = jtsp.random_instance(28, seed=9)
    kw = dict(variant=variant, local_search=local_search, ls_tours=ls_tours,
              ls_every=ls_every, ls_improvement=improvement,
              use_pallas=use_pallas, rho=rho, seed=4, nn_k=8, ls_rounds=10,
              iterations=3)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj, pt = _problems(inst, 8)
    sj, st = jaco.init_colony(inst, cj), taco.init_colony(inst, ct, device="cpu")
    exact = not use_pallas or variant != "as"
    for i in range(3):
        sj, bj = jaco.colony_step(pj, sj, cj)
        st, bt = taco.colony_step(pt, st, ct)
        assert_bitwise(bj, bt, f"step {i} iteration-best length")
        _assert_state(sj, st, exact, f"step {i}")
    # run() drives the same steps (and the same compiled reference step)
    _assert_state(jaco.run(inst, cj), taco.run(inst, ct, device="cpu"),
                  exact, "run")


def test_masked_colony_step_with_local_search_vs_jax():
    inst = jtsp.pad_instance(jtsp.random_instance(19, seed=5), 24)
    kw = dict(variant="mmas", local_search="2opt_oropt", seed=7, nn_k=8,
              use_pallas=True, rho=0.5, ls_rounds=8)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj, pt = _problems(inst, 8, 19)
    sj, st = jaco.init_colony(inst, cj), taco.init_colony(inst, ct, device="cpu")
    for i in range(2):
        sj, _ = jaco.colony_step(pj, sj, cj)
        st, _ = taco.colony_step(pt, st, ct)
        _assert_state(sj, st, True, f"masked step {i}")
