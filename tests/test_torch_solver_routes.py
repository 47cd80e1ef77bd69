"""Port parity for the batched engine's routes: ``repro_torch.solver.engine
.run_batch`` against ``repro.solver.engine`` on the four instances of
tests/test_solver.py in bucket 16 (every slot masked): the pure route
(AS/MMAS/ACS with and without local search), the kernel route, the
stacked kernel routes, a quantised store, Hyper profiles and patience.
The tolerances are tests/test_torch_solver.py's: tours, best lengths,
iterations and keys bitwise; tau bitwise except where that file's
docstring says (rtol 1e-5 / atol 1e-7).  Split from that file so that the
test runner's workers share the two.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from test_torch_solver import (BUDGETS, INSTS, SEEDS, _both,  # noqa: E402
                               assert_states)
from torch_parity import assert_bitwise  # noqa: E402

PURE = [(v, ls, 0.1) for v in ("as", "mmas", "acs")
        for ls in ("none", "2opt", "2opt_oropt")] + \
    [(v, "none", 0.5) for v in ("as", "mmas", "acs")]


PURE = [(v, ls, 0.1) for v in ("as", "mmas", "acs")
        for ls in ("none", "2opt", "2opt_oropt")] + \
    [(v, "none", 0.5) for v in ("as", "mmas", "acs")]


@pytest.mark.parametrize("variant,ls,rho", PURE)
def test_engine_equals_reference_pure_route(variant, ls, rho):
    """Masked bucket, mixed budgets, iroulette, with and without local
    search."""
    sj, st, _ = _both(dict(variant=variant, local_search=ls, ls_rounds=4,
                           rho=rho, iterations=6))
    assert_states(sj, st, tau_exact=variant != "acs")


@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_engine_kernel_route_equals_reference_kernel_route(variant):
    """The port's kernel route (plain versions on the CPU) against the
    reference's ``use_pallas`` engine (Pallas in interpret mode), under
    ``test_kernel_route_vs_jax_kernel_route``'s contract: tours and lengths
    bitwise; tau bitwise for MMAS, at TOL for AS/ACS at rho 0.1."""
    sj, st, _ = _both(dict(variant=variant, use_pallas=True, rho=0.1,
                           iterations=6))
    assert_states(sj, st, tau_exact=variant == "mmas")


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True, construction="pallas"),
    dict(use_pallas=True, local_search="2opt", ls_rounds=4),
])
def test_engine_stacked_kernel_routes_equal_reference(kw):
    """The kernel routes whose whole bucket the port steps as one stack
    (the ``pallas`` construction: one ``choice_info`` and one
    ``tour_select`` call a step; local search: one ``two_opt_best`` call a
    round) against the reference's vmapped engine (Pallas in interpret
    mode), under ``test_kernel_route_vs_jax_kernel_route``'s contract:
    tours, lengths, iterations and keys bitwise; AS tau (several ants'
    deposits a cell) at TOL."""
    sj, st, _ = _both(dict(iterations=6, **kw))
    assert_states(sj, st, tau_exact=False)


@pytest.mark.parametrize("kw", [dict(variant="mmas", tau_dtype="int8"),
                                dict(variant="as", tau_dtype="bf16",
                                     use_pallas=True)])
def test_engine_quantised_store_equals_reference(kw):
    """An int8 (pure route) or bf16 (kernel route, rho 0.5) store: the
    payload, row scales and tours bitwise."""
    sj, st, _ = _both(dict(iterations=6, **kw))
    assert_states(sj, st)


@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_engine_hyper_profiles_equal_reference(variant):
    """The four profiles of test_per_instance_hyperparams_exactness: one
    bucket mixes alpha/beta/rho/q; tau0 takes the profile's rho.  Tours
    bitwise; tau bitwise but ACS's (TOL, the vmapped local rule)."""
    profiles = [dict(), dict(alpha=2.0, rho=0.3), dict(beta=3.0, q=2.0),
                dict(rho=0.8)]
    kw = dict(variant=variant, selection="gumbel", iterations=6)
    sj, st, _ = _both(kw, hypers=profiles)
    assert_states(sj, st, tau_exact=variant != "acs")
    # batched == solo in the port, bitwise
    ct = taco.ACOConfig(**kw)
    for i, inst in enumerate(INSTS):
        s1, _ = teng.solve_instances(
            [inst], ct, iterations=[BUDGETS[i]], seeds=[SEEDS[i]], n_pad=16,
            hypers=[taco.Hyper.make(ct, device="cpu", **profiles[i])],
            device="cpu")
        for a, b in zip(tree.flatten(tree.index(st, i)),
                        tree.flatten(tree.index(s1, 0))):
            assert_bitwise(a, b, f"hyper slot {i}")


def test_engine_patience_equals_reference():
    sj, st, _ = _both(dict(variant="mmas", iterations=12),
                      budgets=(12, 12, 12, 12), patience=2)
    assert_states(sj, st)
    assert int(st.iteration.min()) < 12          # patience stopped some
