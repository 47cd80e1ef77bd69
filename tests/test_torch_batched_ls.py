"""Local search over a stack of instances on the CPU.

- ``localsearch.improve`` over (B, m, n) tours (the reference's local
  search under ``vmap``) against per-instance ``improve``: 2-opt, Or-opt
  and both, best and first improvement, padded (three mixed n_actual in a
  bucket of 16) and unpadded; one ``two_opt_best`` call a round for the
  whole stack, the stack's rounds the most any instance needs.
- ``engine.run_batch`` with local search (fused and ``pallas``
  constructions) bitwise a per-slot loop of ``colony_step``: slots that
  start at different iterations under ``ls_every=2``, ``ls_tours=
  "iteration_best"``, metrics on; one walk call per engine iteration and
  one ``two_opt_best`` call per round of the stack; local search over
  groups of slots (``localsearch.slots_per_pass``) the same as one stack.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.core import aco, localsearch, tsp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.solver import batch, engine  # noqa: E402
from torch_parity import assert_bitwise, per_slot_steps  # noqa: E402

N_PAD = 16
N_ACT = (16, 11, 13)                     # exact fit, two padded slots
M = 5


def _stack(padded: bool, seed=0):
    ns = N_ACT if padded else (N_PAD,) * 3
    insts = [tsp.random_instance(n, seed=n + seed) for n in ns]
    b = batch.make_batch(insts, N_PAD, nn_k=6, device="cpu")
    rng = np.random.default_rng(seed)
    tours = torch.tensor(np.stack([
        np.stack([np.concatenate([rng.permutation(n), np.arange(n, N_PAD)])
                  for _ in range(M)]) for n in ns]).astype(np.int32))
    n_act = torch.tensor(ns, dtype=torch.int32) if padded else None
    return b.problem, tours, ns, n_act


def _count_two_opt(monkeypatch, calls):
    real = ops.two_opt_best

    def call(*a, **kw):
        calls["two_opt_best"] = calls.get("two_opt_best", 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "two_opt_best", call)


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("improvement", ["best", "first"])
@pytest.mark.parametrize("kind", ["2opt", "oropt", "2opt_oropt"])
def test_stacked_improve_equals_per_instance(kind, improvement, padded,
                                             monkeypatch):
    prob, tours, ns, n_act = _stack(padded)
    cfg = localsearch.LocalSearchConfig(kind=kind, rounds=12,
                                        improvement=improvement,
                                        use_pallas=True)
    calls = {}
    _count_two_opt(monkeypatch, calls)
    localsearch.improve.rounds = 0
    got, lens = localsearch.improve_with_lengths(prob.dist, prob.nn, tours,
                                                 cfg, n_act)
    rounds = localsearch.improve.rounds
    assert calls.get("two_opt_best", 0) == (rounds if "2opt" in kind else 0)
    monkeypatch.undo()
    solo_rounds = []
    for b in range(3):
        localsearch.improve.rounds = 0
        one, one_len = localsearch.improve_with_lengths(
            prob.dist[b], prob.nn[b], tours[b], cfg,
            ns[b] if padded else None)
        solo_rounds.append(localsearch.improve.rounds)
        assert_bitwise(got[b], one, f"tours {b}")
        assert_bitwise(lens[b], one_len, f"lengths {b}")
        assert torch.equal(got[b, :, ns[b]:], tours[b, :, ns[b]:])
    assert rounds == max(solo_rounds) and rounds > 1


def _ls_stack(cfg, seeds=(4, 5, 6), its=(0, 1, 3)):
    """A bucket of three slots whose counters start at ``its`` (a refilled
    streaming pool's slots sit at different iterations)."""
    insts = [tsp.random_instance(n, seed=n) for n in N_ACT]
    b = batch.make_batch(insts, N_PAD, nn_k=6, device="cpu")
    init = engine.init_states(insts, cfg, list(seeds), N_PAD, device="cpu")
    init = init._replace(iteration=torch.tensor(its, dtype=torch.int32))
    return b, init


LS_CASES = [
    dict(variant="mmas", local_search="2opt", ls_every=2),
    dict(variant="mmas", local_search="2opt", tau_dtype="int8",
         metrics=True),
    dict(variant="as", local_search="2opt_oropt", ls_tours="iteration_best",
         ls_improvement="first", rho=0.1),
    dict(variant="acs", local_search="oropt", selection="gumbel",
         ls_every=2, ls_tours="iteration_best"),
    dict(variant="mmas", local_search="2opt", construction="pallas",
         ls_every=2, metrics=True),
]


@pytest.mark.parametrize("kw", LS_CASES)
def test_run_batch_local_search_stack_equals_per_slot_steps(kw,
                                                            monkeypatch):
    cfg = aco.ACOConfig(use_pallas=True, ls_rounds=6, **kw)
    b, init = _ls_stack(cfg)
    budgets = [4, 4, 6]                  # absolute: 4, 3 and 3 iterations
    calls = {}
    _count_two_opt(monkeypatch, calls)
    walk = "fused_walk" if cfg.construction == "data_parallel" \
        else "tour_select"
    real_walk = getattr(ops, walk)

    def counted_walk(first, *a, **kw):
        calls[walk] = calls.get(walk, 0) + 1
        assert first.dim() == 3
        return real_walk(first, *a, **kw)

    monkeypatch.setattr(ops, walk, counted_walk)
    localsearch.improve.rounds = 0
    out = engine.run_batch(b.problem, init, budgets, cfg, 6)
    rounds = localsearch.improve.rounds
    monkeypatch.undo()
    want_s, want_since, want_rows = per_slot_steps(b.problem, init, budgets,
                                                   cfg, 6)
    for x, y in zip(tree.flatten(out[0]), tree.flatten(want_s)):
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert_bitwise(x, y, "states")
    assert_bitwise(out[1], want_since, "since")
    if cfg.metrics:
        for f in obs_metrics.StepMetrics._fields:
            assert_bitwise(getattr(out[2], f), getattr(want_rows, f), f)
    assert out[0].iteration.tolist() == budgets
    engine_its = 4                       # slot 1 from 1 to 4, slot 2 3 to 6
    per_its = 1 if walk == "fused_walk" else N_PAD - 1
    assert calls[walk] == engine_its * per_its
    assert calls.get("two_opt_best", 0) == \
        (rounds if "2opt" in cfg.local_search else 0)
    assert rounds > 0


@pytest.mark.parametrize("per", [1, 2])
def test_local_search_in_groups_equals_one_stack(per, monkeypatch):
    """Where the card's free memory holds fewer slots, local search runs
    over groups of them: the same states as one stack."""
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True, local_search="2opt",
                        ls_rounds=6, ls_every=2)
    b, init = _ls_stack(cfg)
    whole = engine.run_batch(b.problem, init, [4, 4, 6], cfg, 6)
    monkeypatch.setattr(localsearch, "slots_per_pass",
                        lambda device, n_slots, m, n, k: per)
    grouped = engine.run_batch(b.problem, init, [4, 4, 6], cfg, 6)
    for x, y in zip(tree.flatten(grouped), tree.flatten(whole)):
        assert_bitwise(x, y, f"groups of {per}")


def test_slots_per_pass_takes_the_whole_stack_on_the_cpu():
    assert localsearch.slots_per_pass(torch.device("cpu"), 8, 2048, 2048,
                                      30) == 8
