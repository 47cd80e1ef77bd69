"""The port on the GPU: each CUDA kernel against its plain PyTorch version,
and the kernel route on the card against the same colony on the CPU.

Every test here needs a CUDA device and skips without one; this file
imports no JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: selection indices and choice values bitwise (the kernels round
every operation as the plain versions do, with accurate ``logf``), with a
float32 or a quantised (int8, bf16) tau, dense or on sparse candidate
pages; 2-opt move deltas and indices bitwise; the edge-stream update
bitwise where each cell gets at most one deposit, rtol 1e-5 / atol 1e-7
where atomics sum several deposits in another order; the tours-driven
update (the colony step's) bitwise for any number of ants, and the same
from launch to launch; the sparse walk kernel bitwise against the plain
walk on the card (and, for iroulette and greedy, on the CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aco, localsearch, quant, tsp  # noqa: E402
from repro_torch.kernels import choice_info as ci  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from repro_torch.kernels import tour_select as ts  # noqa: E402
from repro_torch.kernels import sparse_select as ss  # noqa: E402
from repro_torch.kernels import two_opt as to  # noqa: E402
from torch_parity import cuda_device  # noqa: E402

MODES = ["iroulette", "greedy", "gumbel"]


def _inputs(n, dev):
    rng = np.random.default_rng(n)
    tau = (rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32)
    eta = (1.0 / (rng.random((n, n)) * 100 + 1)).astype(np.float32)
    visited = rng.random((n, n)) < 0.5
    rand = (rng.random((n, n)) * (1 - 1e-6) + 1e-6).astype(np.float32)
    cur = rng.integers(0, n, n).astype(np.int32)
    return (torch.tensor(a, device=dev)
            for a in (tau, eta, visited, rand, cur))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_actual", [(1002, None), (2392, None),
                                        (997, None), (1002, 901)])
def test_selection_kernels_bitwise(n, n_actual):
    tau, eta, visited, rand, cur = _inputs(n, cuda_device())
    rows = ci.choice_info_plain(tau, eta, 1.0, 2.0)[cur.long()]
    for mode in MODES:
        assert torch.equal(
            ts.tour_select(rows, visited, rand, mode, n_actual),
            ts.tour_select_plain(rows, visited, rand, mode, n_actual)), mode
        assert torch.equal(
            fs.fused_select(tau, eta, cur, visited, rand, 1.0, 2.0, n_actual,
                            mode),
            fs.fused_select_plain(tau, eta, cur, visited, rand, 1.0, 2.0,
                                  n_actual, mode)), mode
    for alpha, beta in ((1.0, 2.0), (2.0, 3.0)):
        assert torch.equal(ci.choice_info(tau, eta, alpha, beta, n_actual),
                           ci.choice_info_plain(tau, eta, alpha, beta,
                                                n_actual))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_ants", [(501, 1), (501, 64), (2392, 1),
                                      (2392, 2392)])
def test_pheromone_update_kernel(n, n_ants):
    """The tours-driven row-owner kernel: bitwise the CPU plain composition
    for every number of ants (its deposits land in the edge stream's
    order), unpadded and with n_actual = n - 7, and identical from one
    launch to the next."""
    dev = cuda_device()
    rng = np.random.default_rng(n_ants)
    tau = torch.tensor((rng.random((n, n)) * 1e-2).astype(np.float32),
                       device=dev)
    tours = torch.tensor(np.stack([rng.permutation(n)
                                   for _ in range(n_ants)]).astype(np.int32),
                         device=dev)
    w = torch.tensor((rng.random(n_ants) * 1e-2).astype(np.float32),
                     device=dev)
    ops.reset_launch_counts()
    for rho in (0.5, 0.1):
        for n_actual in (None, n - 7):
            got = ops.pheromone_update(tau, tours, w, rho, n_actual)
            want = ops.pheromone_update(tau.cpu(), tours.cpu(), w.cpu(), rho,
                                        n_actual)
            assert torch.equal(got.cpu(), want), (rho, n_actual)
            again = ops.pheromone_update(tau, tours, w, rho, n_actual)
            assert torch.equal(again, got), (rho, n_actual)
    assert ops.launch_counts()["pheromone_update_tours"] == 8
    assert ops.launch_counts()["pheromone_update"] == 0


@pytest.mark.cuda
def test_addcmul_and_draw_on_card_equal_cpu():
    """The one-rounding multiply-add that stands for the reference's fused
    one, and the per-step uniform draw built on it, bitwise card vs CPU."""
    from repro_torch.core import sampling, strategies
    dev = cuda_device()
    rng = np.random.default_rng(0)
    a, b, c = (torch.tensor(rng.random((300, 200)).astype(np.float32))
               for _ in range(3))
    for mult in (torch.tensor(0.9), b):
        assert torch.equal(
            torch.addcmul(c.to(dev), mult.to(dev), a.to(dev)).cpu(),
            torch.addcmul(c, mult, a))
    for mode in ("packed", "counter"):
        assert torch.equal(
            strategies._draw_step_uniform(sampling.prng_key(7, dev),
                                          (97, 131), mode).cpu(),
            strategies._draw_step_uniform(sampling.prng_key(7, "cpu"),
                                          (97, 131), mode)), mode


@pytest.mark.cuda
def test_kernel_route_on_card_equals_cpu_route():
    """MMAS (one deposit per cell): tours, best_len and tau bitwise between
    the card's kernels and the CPU's plain versions; every kernel of the
    route is launched."""
    dev = cuda_device()
    inst = tsp.random_instance(60, seed=2)
    for construction, launched in (("data_parallel", "fused_select"),
                                   ("pallas", "tour_select")):
        cfg = aco.ACOConfig(variant="mmas", iterations=4, seed=5,
                            use_pallas=True, construction=construction)
        ops.reset_launch_counts()
        gpu = aco.run(inst, cfg, device=dev)
        assert ops.launch_counts()[launched] == 4 * 59
        cpu = aco.run(inst, cfg, device="cpu")
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b), construction


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_actual", [(1002, None), (2392, None),
                                        (997, None), (1002, 901)])
@pytest.mark.parametrize("tau_dtype", ["int8", "bf16"])
def test_fused_select_quant_kernel_bitwise(n, n_actual, tau_dtype):
    tau, eta, visited, rand, cur = _inputs(n, cuda_device())
    qt = quant.quantise(tau, tau_dtype,
                        key=torch.tensor([0, n], device=tau.device))
    scale = qt.scale if tau_dtype == "int8" else None
    ops.reset_launch_counts()
    for mode in MODES:
        assert torch.equal(
            ops.fused_select(qt.q, eta, cur, visited, rand, 1.0, 2.0,
                             n_actual, mode, tau_scale=scale),
            fs.fused_select_quant_plain(qt.q, scale, eta, cur, visited, rand,
                                        1.0, 2.0, n_actual, mode)), mode
    assert ops.launch_counts()["fused_select_quant"] == len(MODES)
    assert ops.launch_counts()["fused_select"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_actual", [None, 901])
def test_two_opt_best_kernel_bitwise(n_actual):
    """Operands from real tours through _two_opt_operands, k = 30."""
    dev = cuda_device()
    inst = tsp.random_instance(1002, seed=3)
    if n_actual is not None:
        inst = tsp.pad_instance(tsp.random_instance(n_actual, seed=3), 1002)
    prob = aco.make_problem(inst, 30, dev)
    n_real = 1002 if n_actual is None else n_actual
    gen = torch.Generator(device=dev).manual_seed(1)
    tours = torch.stack([torch.cat([torch.randperm(n_real, generator=gen,
                                                   device=dev),
                                    torch.arange(n_real, 1002, device=dev)])
                         for _ in range(257)]).to(torch.int32)
    a1, a2, r1, r2, valid, _ = localsearch._two_opt_operands(
        prob.dist, prob.nn, tours, n_actual)
    flat = [x.reshape(257, -1) for x in (a1, a2, r1, r2, valid)]
    for mode in ("best", "first"):
        got = to.two_opt_best(*flat, thr=1e-3, mode=mode)
        want = to.two_opt_best_plain(*flat, thr=1e-3, mode=mode)
        assert torch.equal(got[0], want[0]), mode
        assert torch.equal(got[1], want[1]), mode


@pytest.mark.cuda
def test_local_search_and_quantised_colony_on_card_equal_cpu():
    """MMAS + 2-opt/Or-opt and MMAS over an int8 store (with and without
    the compensation residual): the card's kernel route equals the CPU
    route bit for bit (tours, best_len, payload, scale, residual); K5
    launches once per local-search round."""
    dev = cuda_device()
    inst = tsp.random_instance(60, seed=4)
    for kw in (dict(local_search="2opt_oropt"), dict(tau_dtype="int8"),
               dict(tau_dtype="int8", tau_compensation=True)):
        cfg = aco.ACOConfig(variant="mmas", iterations=3, seed=2,
                            use_pallas=True, **kw)
        ops.reset_launch_counts()
        localsearch.improve.rounds = 0
        gpu = aco.run(inst, cfg, device=dev)
        counts = ops.launch_counts()
        assert counts["two_opt_best"] == localsearch.improve.rounds
        if "tau_dtype" in kw:
            assert counts["fused_select_quant"] == 3 * 59
        cpu = aco.run(inst, cfg, device="cpu")
        for a, b in zip(gpu[1:], cpu[1:]):
            assert torch.equal(a.cpu(), b), kw
        ta, tb = (gpu.tau, cpu.tau) if "tau_dtype" not in kw else \
            (gpu.tau.q, cpu.tau.q)
        assert torch.equal(ta.cpu(), tb), kw
        if "tau_dtype" in kw:
            assert torch.equal(gpu.tau.scale.cpu(), cpu.tau.scale)
            assert torch.equal(gpu.tau.err.cpu(), cpu.tau.err)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(1002, 64, 16), (2392, 64, 16),
                                   (2392, 2392, 32)])
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_sparse_select_kernel_bitwise(n, m, k, tau_dtype):
    tau, scale, eta, cities, visited, rand = ss.page_operands(
        n, m, k, tau_dtype, cuda_device(), seed=n + m)
    ops.reset_launch_counts()
    for mode in MODES:
        got = ops.sparse_select(tau, eta, cities, visited, rand, 1.0, 2.0,
                                mode, tau_scale=scale)
        want = ss.sparse_select_quant_plain(tau, scale, eta, cities, visited,
                                            rand, 1.0, 2.0, mode)
        assert torch.equal(got[0], want[0]), mode
        assert torch.equal(got[1], want[1]), mode
        assert int(got[1][:4].sum()) == 0
    name = "sparse_select" if tau_dtype == "fp32" else "sparse_select_quant"
    assert ops.launch_counts()[name] == len(MODES)


@pytest.mark.cuda
def test_sparse_colonies_on_card_equal_cpu():
    """Sparse MMAS (data-parallel and Partial-ACO) and sparse MMAS over
    int8 pages, k = 4 with 4 overflow slots: the card's kernel route equals
    the CPU route bit for bit in every state field; the walk kernel
    launches once per iteration and the one-step K7 never."""
    dev = cuda_device()
    inst = tsp.random_instance(100, seed=5)
    for kw in (dict(), dict(construction="partial", partial_window=16),
               dict(tau_dtype="int8")):
        cfg = aco.ACOConfig(variant="mmas", sparse=True, sparse_k=4,
                            sparse_overflow=4, m=16, iterations=4, seed=3,
                            use_pallas=True, **kw)
        ops.reset_launch_counts()
        gpu = aco.run(inst, cfg, device=dev)
        counts = ops.launch_counts()
        assert counts["sparse_walk"] == 4, kw
        assert counts["sparse_select"] == counts["sparse_select_quant"] == 0
        cpu = aco.run(inst, cfg, device="cpu")
        flat = [(a, b) for x, y in zip(gpu, cpu)
                for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]
        for a, b in flat:
            assert torch.equal(a.cpu(), b), kw


def _to_cpu(x):
    """A tensor, or a named tuple of tensors and plain values, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(_to_cpu(y) for y in x))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "counter", "padded", "partial",
                                  "att"])
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_sparse_walk_kernel_bitwise(tau_dtype, case):
    """One sparse_walk launch against the plain walk on the card (every
    step through the plain versions, sparse_select_plain included): the
    cities, edge lengths, visited rows and fallback counts bitwise, in all
    three modes; iroulette and greedy also against the CPU.  n = 300,
    k = 8 + 4 overflow slots, m = 32 (the route's shapes are in
    chip_smoke.py)."""
    dev = cuda_device()
    draw = "counter" if case == "counter" else "packed"
    ewt = "ATT" if case == "att" else "EUC_2D"
    operands = ss.walk_operands(
        300, 32, 8, 4, tau_dtype, dev, seed=11,
        n_pad=307 if case == "padded" else None,
        window=40 if case == "partial" else None, ewt=ewt)
    problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
    n_act = problem.n_actual
    for mode in MODES:
        vis_k, vis_p = visited.clone(), visited.clone()
        ops.reset_launch_counts()
        got = ops.sparse_walk(problem, tau, ovf_city, ovf_tau, start, vis_k,
                              keys, mode, 1.0, 2.0, ewt, draw, n_act)
        assert ops.launch_counts()["sparse_walk"] == 1
        want = ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau, start,
                                    vis_p, keys, mode, 1.0, 2.0, ewt, draw,
                                    n_act)
        for g, w, what in zip(got, want, ("cities", "lengths", "fallbacks")):
            assert torch.equal(g, w), (mode, what)
        assert torch.equal(vis_k, vis_p), mode
        assert int(got[2].sum()) > 0, mode
        if mode == "gumbel":
            continue
        cpu = [_to_cpu(x) for x in operands]
        vis_c = cpu[5].clone()
        want_c = ss.sparse_walk_plain(cpu[0], cpu[1], cpu[2], cpu[3], cpu[4],
                                      vis_c, cpu[6], mode, 1.0, 2.0, ewt,
                                      draw, n_act)
        for g, w, what in zip(got, want_c, ("cities", "lengths",
                                            "fallbacks")):
            assert torch.equal(g.cpu(), w), (mode, what, "cpu")
        assert torch.equal(vis_k.cpu(), vis_c), mode
