"""The instance axis on the CPU: the batched step against per-instance calls.

- ``sampling`` (``split``, ``random_bits``, ``randint`` with per-row
  bounds), ``tsp.tour_length``, ``pheromone.tour_edges`` /
  ``local_update_acs``, ``quant.requantise``, ``aco.mmas_bounds`` and
  ``obs.metrics.step_metrics`` over a (B, ...) stack: every row bitwise
  the instance's own call.
- The batched plain walk and update (the CPU path of ``ops.fused_walk``
  and ``ops.pheromone_update`` on a (B, n, n) stack) against single calls:
  mixed ``n_actual``, one inactive slot, fp32/int8/bf16 x
  iroulette/gumbel/greedy; the launchers' shape and alignment checks.
- ``engine.run_batch`` on the fused kernel route (one
  ``colony_step_batch`` per engine iteration) bitwise a per-slot loop of
  ``colony_step``, AS/MMAS/ACS x fp32/int8/bf16 x metrics on/off, with
  frozen slots and ``patience``; one walk and one update call per engine
  iteration whatever the number of active slots.
- The Choice kernel and the selection over a stack (the CPU path of
  ``ops.choice_info`` / ``ops.tour_select`` on (B, ...) operands) against
  single calls, with an inactive slot; the ``pallas`` construction over a
  stack against per-instance ``construct_tours`` (packed and counter
  draws, three modes); ``run_batch`` on the ``pallas`` route bitwise the
  per-slot steps, with one ``choice_info`` call per engine iteration and
  max n_actual - 1 ``tour_select`` calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.core import aco, pheromone, quant, sampling  # noqa: E402
from repro_torch.core import strategies, tsp  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.solver import batch, engine  # noqa: E402
from torch_parity import (OnCard, assert_bitwise,  # noqa: E402
                          per_slot_steps)

MODES = ["iroulette", "gumbel", "greedy"]
N_PAD = 32
N_ACT = (32, 27, 19)                     # exact fit, two padded slots


def _keys(b, seed=0):
    return torch.stack([sampling.prng_key(seed + 7 * i) for i in range(b)])


def _leaves_equal(a, b, what=""):
    for x, y in zip(tree.flatten(a), tree.flatten(b)):
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert_bitwise(x, y, what)


# ------------------------------------------------------------ substrate
def test_batched_sampling_rows_equal_solo():
    keys = _keys(4, seed=3)
    hi = torch.tensor([5, 1, 1000, 65537], dtype=torch.int32)
    sp = sampling.split(keys, 3)
    bits = sampling.random_bits(keys, (3, 5))
    ints = sampling.randint(keys, (7,), 0, hi)
    assert sp.shape == (4, 3, 2) and bits.shape == (4, 3, 5)
    for b in range(4):
        assert_bitwise(sp[b], sampling.split(keys[b], 3), "split")
        assert_bitwise(bits[b], sampling.random_bits(keys[b], (3, 5)),
                       "bits")
        assert_bitwise(ints[b], sampling.randint(keys[b], (7,), 0,
                                                 int(hi[b])), "randint")
    starts = strategies.place_ants(keys[:3], 9, N_PAD,
                                   torch.tensor(N_ACT, dtype=torch.int32))
    for b in range(3):
        assert_bitwise(starts[b], strategies.place_ants(keys[b], 9, N_PAD,
                                                        N_ACT[b]), "place")
        assert int(starts[b].max()) < N_ACT[b]


def _stack_problem(tau_dtype="fp32"):
    insts = [tsp.random_instance(n, seed=n) for n in N_ACT]
    b = batch.make_batch(insts, N_PAD, device="cpu")
    return insts, b


def test_batched_lengths_edges_and_acs_rule_equal_solo():
    _, b = _stack_problem()
    rng = np.random.default_rng(0)
    tours = torch.tensor(np.stack([
        np.stack([np.concatenate([rng.permutation(na),
                                  np.arange(na, N_PAD)]) for _ in range(6)])
        for na in N_ACT]).astype(np.int32))
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    lens = tsp.tour_length(b.problem.dist, tours, n_act)
    f, t = pheromone.tour_edges(tours, n_act)
    tau = torch.rand((3, N_PAD, N_PAD), generator=torch.Generator()
                     .manual_seed(1)) + 0.5
    tau0 = torch.tensor([1e-3, 2e-3, 3e-3])
    ew = (torch.arange(N_PAD) < n_act[:, None, None]).float().expand(
        tours.shape).reshape(3, -1)
    acs = pheromone.local_update_acs(tau, f.reshape(3, -1), t.reshape(3, -1),
                                     0.1, tau0, w=ew)
    for i, na in enumerate(N_ACT):
        assert_bitwise(lens[i], tsp.tour_length(b.problem.dist[i], tours[i],
                                                na), "tour_length")
        fs_, ts_ = pheromone.tour_edges(tours[i], na)
        assert_bitwise(t[i], ts_, "tour_edges")
        w = (torch.arange(N_PAD) < na).float().expand(6, N_PAD).reshape(-1)
        assert_bitwise(acs[i], pheromone.local_update_acs(
            tau[i], fs_.reshape(-1), ts_.reshape(-1), 0.1, tau0[i], w=w),
            "acs")


@pytest.mark.parametrize("tau_dtype,tau_round,comp", [
    ("int8", "stochastic", False), ("int8", "nearest", True),
    ("bf16", "stochastic", True), ("bf16", "nearest", False)])
def test_batched_requantise_rows_equal_solo(tau_dtype, tau_round, comp):
    g = torch.Generator().manual_seed(2)
    x = torch.rand((3, N_PAD, N_PAD), generator=g) * 1e-2
    prev = quant.quantise(torch.rand((3, N_PAD, N_PAD), generator=g),
                          tau_dtype, compensation=comp)
    keys = _keys(3, seed=5)
    got = quant.requantise(x, prev, tau_dtype,
                           quant.round_key(tau_round, keys))
    for i in range(3):
        want = quant.requantise(x[i], tree.index(prev, i), tau_dtype,
                                quant.round_key(tau_round, keys[i]))
        _leaves_equal(tree.index(got, i), want, tau_dtype)


def test_batched_bounds_and_metrics_rows_equal_solo():
    g = torch.Generator().manual_seed(3)
    best = torch.rand(3, generator=g) * 1000 + 100
    cfg = aco.ACOConfig(variant="mmas", rho=0.1)
    lo, hi = aco.mmas_bounds(best, cfg, N_PAD,
                             torch.tensor(N_ACT, dtype=torch.int32))
    tau = torch.rand((3, N_PAD, N_PAD), generator=g)
    tau = torch.clamp(tau, min=lo[:, None, None], max=hi[:, None, None])
    lengths = torch.rand((3, 11), generator=g) * 100
    pre = lengths + torch.rand((3, 11), generator=g) - 0.5
    it_best = lengths.min(-1).values
    improved = it_best < best
    rows = obs_metrics.step_metrics(lengths, it_best, best, improved, tau,
                                    (lo, hi), pre)
    for i, na in enumerate(N_ACT):
        lo_i, hi_i = aco.mmas_bounds(best[i], cfg, N_PAD, na)
        assert_bitwise(lo[i], lo_i, "tau_min")
        assert_bitwise(hi[i], hi_i, "tau_max")
        want = obs_metrics.step_metrics(lengths[i], it_best[i], best[i],
                                        improved[i], tau[i], (lo_i, hi_i),
                                        pre[i])
        _leaves_equal(tree.index(rows, i), want, "metrics")


# ------------------------------------------------------------ walk, update
def _walk_operands(tau_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    tau = torch.rand((3, N_PAD, N_PAD), generator=g) * 1e-2 + 1e-3
    eta = 1.0 / (torch.rand((3, N_PAD, N_PAD), generator=g) * 100 + 1)
    scale = None
    if tau_dtype != "fp32":
        qt = quant.quantise(tau, tau_dtype)
        tau, scale = qt.q, (qt.scale if tau_dtype == "int8" else None)
    start = torch.stack([torch.randint(0, na, (9,), generator=g)
                         for na in N_ACT]).to(torch.int32)
    return tau, scale, eta, start, _keys(3, seed=seed)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_batched_plain_walk_equals_single_walks(tau_dtype, mode):
    tau, scale, eta, start, keys = _walk_operands(tau_dtype)
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    active = (True, False, True)
    got = ops.fused_walk(tau, eta, start, keys, 1.0, 2.0, n_act, mode,
                         tau_scale=scale, active=active)
    assert got.shape == (3, N_PAD - 1, 9)
    assert not got[1].any()                          # inactive: untouched
    for b in (0, 2):
        want = ops.fused_walk(tau[b], eta[b], start[b], keys[b], 1.0, 2.0,
                              N_ACT[b], mode,
                              tau_scale=None if scale is None else scale[b])
        assert_bitwise(got[b], want, f"walk slot {b}")
    # the construction over the stack: tours and lengths of each slot
    _, bt = _stack_problem()
    res = strategies.construct_tours(
        keys, bt.problem.dist, None, 9, method="fused", selection=mode,
        tau=tau, eta=eta, n_actual=n_act, tau_scale=scale, active=active)
    for b in (0, 2):
        one = strategies.construct_tours(
            keys[b], bt.problem.dist[b], None, 9, method="fused",
            selection=mode, tau=tau[b], eta=eta[b], n_actual=N_ACT[b],
            tau_scale=None if scale is None else scale[b])
        assert_bitwise(res.tours[b], one.tours, "tours")
        assert_bitwise(res.lengths[b], one.lengths, "lengths")


@pytest.mark.parametrize("m", [9, 1])
def test_batched_plain_update_equals_single_updates(m):
    g = torch.Generator().manual_seed(m)
    tau = torch.rand((3, N_PAD, N_PAD), generator=g)
    tours = torch.stack([torch.stack([torch.cat([
        torch.randperm(na, generator=g), torch.arange(na, N_PAD)])
        for _ in range(m)]) for na in N_ACT]).to(torch.int32)
    w = torch.rand((3, m), generator=g)
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    got = ops.pheromone_update(tau, tours, w, 0.1, n_act,
                               active=(False, True, True))
    for b in (1, 2):
        assert_bitwise(got[b], ops.pheromone_update(tau[b], tours[b], w[b],
                                                    0.1, N_ACT[b]),
                       f"update slot {b}")


def test_batched_launchers_refuse_bad_stacks():
    """Shapes, n_actual and the per-instance 16-byte alignment are checked
    before any launch; a stack is never copied to align it."""
    tau, _, eta, start, keys = _walk_operands("fp32")
    C = OnCard
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        fs.fused_walk(C(tau), C(eta), C(start[:2].contiguous()), C(keys))
    with pytest.raises(ValueError, match="shape"):
        fs.fused_walk(C(tau), C(eta), C(start), C(keys[0].contiguous()))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_walk(C(tau), C(eta), C(start), C(keys), n_actual=n_act)
    with pytest.raises(ValueError, match="active flags"):
        fs.fused_walk(C(tau), C(eta), C(start), C(keys), active=(True,))
    odd = torch.rand((3, 31, 31))                    # planes 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fs.fused_walk(C(odd), C(torch.rand((3, 31, 31))), C(start),
                      C(keys))
    tours = torch.zeros((3, 1, N_PAD), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        pu.pheromone_update_tours(C(tau), C(tours), C(torch.rand(3, 2)), 0.5)
    with pytest.raises(ValueError, match="n_actual"):
        pu.pheromone_update_tours(C(tau), C(tours), C(torch.rand(3, 1)), 0.5,
                                  n_actual=N_PAD + 1)
    with pytest.raises(ValueError, match="n_actual"):
        fs.fused_walk(C(tau), C(eta), C(start), C(keys), n_actual=0)
    assert fs.fused_walk.launches == 0
    assert pu.pheromone_update_tours.launches == 0


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("metrics", [False, True])
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_run_batch_stack_equals_per_slot_steps(variant, tau_dtype, metrics,
                                               monkeypatch):
    insts = [tsp.random_instance(n, seed=n) for n in (16, 11, 13)]
    cfg = aco.ACOConfig(variant=variant, tau_dtype=tau_dtype, rho=0.1,
                        use_pallas=True, metrics=metrics,
                        selection="gumbel" if variant == "acs"
                        else "iroulette")
    b = batch.make_batch(insts, 16, device="cpu")
    init = engine.init_states(insts, cfg, [4, 5, 6], 16, device="cpu")
    budgets, patience = [5, 2, 4], 2 if variant == "mmas" else 0
    calls = {"walk": 0, "update": 0}
    real_walk, real_update = ops.fused_walk, ops.pheromone_update

    def walk(tau, *a, **kw):
        calls["walk"] += 1
        assert tau.dim() == 3
        return real_walk(tau, *a, **kw)

    def update(tau, *a, **kw):
        calls["update"] += 1
        return real_update(tau, *a, **kw)

    monkeypatch.setattr(ops, "fused_walk", walk)
    monkeypatch.setattr(ops, "pheromone_update", update)
    out = engine.run_batch(b.problem, init, budgets, cfg, 5, patience)
    monkeypatch.undo()
    want_s, want_since, want_rows = per_slot_steps(b.problem, init, budgets,
                                                   cfg, 5, patience)
    _leaves_equal(out[0], want_s, "states")
    assert_bitwise(out[1], want_since, "since")
    if metrics:
        for f in obs_metrics.StepMetrics._fields:
            assert_bitwise(getattr(out[2], f), getattr(want_rows, f), f)
    engine_its = max(int(i) for i in out[0].iteration)
    assert calls == {"walk": engine_its, "update": engine_its}
    assert int(out[0].iteration[1]) == 2           # frozen at its budget


def test_run_batch_stack_donate_and_frozen_leaves():
    """donate=True updates the resident stack in place; a slot that is
    frozen from the start (budget 0, the streaming dummy) keeps every leaf,
    its key included, bitwise."""
    insts = [tsp.random_instance(n, seed=n) for n in (12, 16)]
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True, metrics=True)
    b = batch.make_batch(insts, 16, device="cpu")
    st = engine.init_states(insts, cfg, [1, 2], 16, device="cpu")
    before = tree.map(torch.clone, st)
    kept = engine.run_batch(b.problem, st, [0, 3], cfg, 3)
    _leaves_equal(st, before, "inputs untouched")
    out = engine.run_batch(b.problem, st, [0, 3], cfg, 3, donate=True)
    assert out[0] is st
    _leaves_equal(st, kept[0], "donated")
    _leaves_equal(tree.index(st, 0), tree.index(before, 0), "frozen slot")
    # local search and the pallas construction step the stack too; the
    # pure route and Hyper one instance at a time
    assert aco.batched_route(aco.ACOConfig(use_pallas=True,
                                           local_search="2opt"), b.problem)
    assert aco.batched_route(aco.ACOConfig(use_pallas=True,
                                           construction="pallas"), b.problem)
    assert not aco.batched_route(aco.ACOConfig(local_search="2opt"),
                                 b.problem)
    with pytest.raises(ValueError, match="one instance at a time"):
        aco.colony_step_batch(b.problem, st, aco.ACOConfig(variant="mmas"))


@pytest.mark.parametrize("bad", [0, N_PAD + 1])
def test_step_checks_slot_counts_before_any_launch(bad):
    """The launchers read a (B,) device ``n_actual`` on the card only, so
    the step checks its host values: one out of [1, n] raises, in a stack
    and in a solo step alike, before any walk or update."""
    insts = [tsp.random_instance(n, seed=n) for n in (16, 11)]
    cfg = aco.ACOConfig(variant="mmas", use_pallas=True)
    b = batch.make_batch(insts, 16, device="cpu")
    st = engine.init_states(insts, cfg, [1, 2], 16, device="cpu")
    bad_problem = b.problem._replace(n_actual=(16, bad))
    with pytest.raises(ValueError, match="n_actual"):
        aco.colony_step_batch(bad_problem, st, cfg)
    with pytest.raises(ValueError, match="n_actual"):
        aco.colony_step(batch.slot_problem(bad_problem, 1),
                        tree.index(st, 1), cfg)


@pytest.mark.parametrize("tau_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_fused_route_step_reads_nothing_back(variant, tau_dtype, monkeypatch):
    """Outside the two kernels' wrappers, a step on the fused kernel route
    (solo, and a padded stack) makes no device-to-host read: on the card
    the host queues the whole iteration behind the walk without waiting
    for it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    inside = {"k": 0}

    def wrapped(real):
        def call(*a, **kw):
            inside["k"] += 1
            try:
                return real(*a, **kw)
            finally:
                inside["k"] -= 1
        return call

    for name in ("fused_walk", "pheromone_update"):
        monkeypatch.setattr(ops, name, wrapped(getattr(ops, name)))

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if inside["k"] == 0 and func.overloadpacket in (
                    torch.ops.aten._local_scalar_dense,
                    torch.ops.aten.item):
                Reads.n += 1
            return func(*args, **(kwargs or {}))

    cfg = aco.ACOConfig(variant=variant, tau_dtype=tau_dtype,
                        use_pallas=True)
    inst = tsp.random_instance(24, seed=3)
    prob = aco.make_problem(inst, cfg.nn_k, "cpu")
    st = aco.init_colony(inst, cfg, device="cpu")
    insts = [tsp.random_instance(n, seed=n) for n in (16, 11)]
    b = batch.make_batch(insts, 16, device="cpu")
    stack = engine.init_states(insts, cfg, [1, 2], 16, device="cpu")
    n_act = aco.slot_n_actual(b.problem, "cpu")
    with Reads():
        aco.colony_step(prob, st, cfg)
        aco.colony_step_batch(b.problem, stack, cfg, n_actual=n_act)
    assert Reads.n == 0


# ------------------------------------------------------ K3, K4, pallas
def _choice_stack(seed=0):
    g = torch.Generator().manual_seed(seed)
    tau = torch.rand((3, N_PAD, N_PAD), generator=g) * 1e-2 + 1e-3
    eta = 1.0 / (torch.rand((3, N_PAD, N_PAD), generator=g) * 100 + 1)
    return tau, eta


@pytest.mark.parametrize("alpha,beta", [(1.0, 2.0), (2.0, 3.0), (1.5, 2.0)])
def test_batched_plain_choice_info_equals_single_calls(alpha, beta):
    tau, eta = _choice_stack()
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    got = ops.choice_info(tau, eta, alpha, beta, n_act,
                          active=(True, False, True))
    assert not got[1].any()                          # inactive: untouched
    for b in (0, 2):
        assert_bitwise(got[b], ops.choice_info(tau[b], eta[b], alpha, beta,
                                               N_ACT[b]), f"slot {b}")
        assert not got[b, N_ACT[b]:].any() and not got[b, :, N_ACT[b]:].any()
    full = ops.choice_info(tau, eta, alpha, beta)
    for b in range(3):
        assert_bitwise(full[b], ops.choice_info(tau[b], eta[b], alpha, beta),
                       f"unmasked slot {b}")


@pytest.mark.parametrize("mode", MODES)
def test_batched_plain_tour_select_equals_single_calls(mode):
    g = torch.Generator().manual_seed(5)
    tau, eta = _choice_stack(1)
    rows = ops.choice_info(tau, eta)[:, :9].contiguous()
    visited = torch.rand((3, 9, N_PAD), generator=g) < 0.5
    rand = torch.rand((3, 9, N_PAD), generator=g) * (1 - 1e-6) + 1e-6
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    got = ops.tour_select(rows, visited, rand, mode, n_act,
                          active=(False, True, True))
    assert got.shape == (3, 9) and not got[0].any()
    for b in (1, 2):
        assert_bitwise(got[b], ops.tour_select(rows[b], visited[b], rand[b],
                                               mode, N_ACT[b]), f"slot {b}")
    full = ops.tour_select(rows, visited, rand, mode)
    for b in range(3):
        assert_bitwise(full[b], ops.tour_select(rows[b], visited[b], rand[b],
                                                mode), f"unmasked slot {b}")


def _counting(monkeypatch, calls, *names):
    """Count the ``ops`` calls of ``names``, each on a stack."""
    for name in names:
        real = getattr(ops, name)

        def call(first, *a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            assert first.dim() == 3, _name
            return _real(first, *a, **kw)

        monkeypatch.setattr(ops, name, call)


@pytest.mark.parametrize("draw_mode", ["packed", "counter"])
@pytest.mark.parametrize("mode", MODES)
def test_batched_pallas_construction_equals_single(mode, draw_mode,
                                                   monkeypatch):
    """The ``pallas`` construction over a stack: one selection call a step
    (none past the largest n_actual), each slot bitwise its own
    construction, an inactive slot costing its selections nothing."""
    _, bt = _stack_problem()
    tau, _ = _choice_stack(2)
    n_act = torch.tensor(N_ACT, dtype=torch.int32)
    choice = ops.choice_info(tau, bt.problem.eta, 1.0, 2.0, n_act)
    keys = _keys(3, seed=9)
    calls = {}
    _counting(monkeypatch, calls, "tour_select")
    res = strategies.construct_tours(keys, bt.problem.dist, choice, 9,
                                     method="pallas", selection=mode,
                                     n_actual=n_act, draw_mode=draw_mode,
                                     n_host=N_ACT)
    assert calls == {"tour_select": max(N_ACT) - 1}
    part = strategies.construct_tours(keys, bt.problem.dist, choice, 9,
                                      method="pallas", selection=mode,
                                      n_actual=n_act, draw_mode=draw_mode,
                                      active=(True, False, True))
    monkeypatch.undo()
    assert res.tours.shape == (3, 9, N_PAD)
    for b in range(3):
        one = strategies.construct_tours(
            keys[b], bt.problem.dist[b], choice[b], 9, method="pallas",
            selection=mode, n_actual=N_ACT[b], draw_mode=draw_mode)
        assert_bitwise(res.tours[b], one.tours, f"tours {b}")
        assert_bitwise(res.lengths[b], one.lengths, f"lengths {b}")
        assert torch.equal(res.tours[b, :, N_ACT[b]:],
                           torch.arange(N_ACT[b], N_PAD).expand(9, -1))
        if b != 1:
            assert_bitwise(part.tours[b], one.tours, f"active {b}")


@pytest.mark.parametrize("variant,tau_dtype", [("as", "fp32"),
                                               ("mmas", "int8"),
                                               ("acs", "bf16")])
def test_run_batch_pallas_stack_equals_per_slot_steps(variant, tau_dtype,
                                                      monkeypatch):
    """``run_batch`` on the ``pallas`` construction: one ``choice_info``
    call and max n_actual - 1 ``tour_select`` calls per engine iteration,
    each over the stack, and every slot bitwise its solo steps."""
    insts = [tsp.random_instance(n, seed=n) for n in (16, 11, 13)]
    cfg = aco.ACOConfig(variant=variant, tau_dtype=tau_dtype, rho=0.1,
                        use_pallas=True, construction="pallas",
                        selection="gumbel" if variant == "acs"
                        else "iroulette", metrics=variant == "mmas")
    b = batch.make_batch(insts, 16, device="cpu")
    init = engine.init_states(insts, cfg, [4, 5, 6], 16, device="cpu")
    budgets = [3, 2, 3]
    calls = {}
    _counting(monkeypatch, calls, "choice_info", "tour_select",
              "pheromone_update")
    out = engine.run_batch(b.problem, init, budgets, cfg, 3)
    monkeypatch.undo()
    want_s, want_since, want_rows = per_slot_steps(b.problem, init, budgets,
                                                   cfg, 3, 0)
    _leaves_equal(out[0], want_s, "states")
    assert_bitwise(out[1], want_since, "since")
    if cfg.metrics:
        for f in obs_metrics.StepMetrics._fields:
            assert_bitwise(getattr(out[2], f), getattr(want_rows, f), f)
    assert calls == {"choice_info": 3, "tour_select": 3 * 15,
                     "pheromone_update": 3}
