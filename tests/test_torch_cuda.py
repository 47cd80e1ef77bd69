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
where atomics sum several deposits in another order, over full matrices,
a column slab, a converged stream, E = 0, one row, bad endpoints and
unaligned streams; the tours-driven
update (the colony step's) bitwise for any number of ants, and the same
from launch to launch; the dense and the sparse walk kernels bitwise
against their plain walks on the card (and, for iroulette and greedy, on
the CPU); one launch over a stack of instances (the dense walk and the
update, the sparse walk, the Choice kernel and the selection, the 2-opt
reduction over a stack's folded rows) bitwise single launches and the
plain versions, and the batched engine one walk and one update launch
per engine iteration, dense and sparse, one ``choice_info`` launch per
engine iteration on the ``pallas`` construction and one ``two_opt_best``
launch per local-search round of the stack.  The program cache's CUDA
graphs of an engine iteration replay bitwise the eager iteration with the
same launch counts, and a background warm leaves the capture to the
serving thread.
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


def _edge_stream(rng, n, n_ants, converged=False, slab=None):
    """The symmetric deposit stream of ``n_ants`` closed tours (one tour
    repeated when ``converged``); ``slab`` = (c0, cols) shifts ``to`` into
    a column slab's frame, -1 outside it."""
    if converged:
        tours = np.repeat(rng.permutation(n)[None], n_ants, axis=0)
    else:
        tours = np.stack([rng.permutation(n) for _ in range(n_ants)])
    frm = tours.ravel()
    to = np.roll(tours, -1, axis=-1).ravel()
    wrep = np.repeat((rng.random(n_ants) * 1e-2).astype(np.float32), n)
    f2, t2 = np.concatenate([frm, to]), np.concatenate([to, frm])
    if slab is not None:
        t2 = t2 - slab[0]
        t2 = np.where((t2 >= 0) & (t2 < slab[1]), t2, -1)
    return (f2.astype(np.int32), t2.astype(np.int32),
            np.concatenate([wrep, wrep]).astype(np.float32))


# case -> (n0, n1, slab, converged, ant counts)
EDGE_CASES = {
    "501": (501, 501, None, False, (1, 64, 501)),
    "1002": (1002, 1002, None, False, (1, 64, 1002)),
    "slab": (1002, 334, (334, 334), False, (1, 64, 1002)),
    "converged": (1002, 1002, None, True, (1002,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_pheromone_update_edges_kernel(case):
    """The edge-stream kernel (the city-sharded colony's update) against
    its plain version on the card: one ant bitwise, 64 and m ants and a
    converged stream within rtol 1e-5 / atol 1e-7 (atomics sum a cell's
    deposits in another order).  One call is one launch."""
    n0, n1, slab, conv, ants = EDGE_CASES[case]
    dev = cuda_device()
    rng = np.random.default_rng(n0 + n1 + len(case))
    tau = torch.tensor((rng.random((n0, n1)) * 1e-2 + 1e-3)
                       .astype(np.float32), device=dev)
    ops.reset_launch_counts()
    calls = 0
    for n_ants in ants:
        f, t, w = (torch.tensor(a, device=dev)
                   for a in _edge_stream(rng, n0, n_ants, conv, slab))
        for rho in (0.5, 0.1):
            got = ops.pheromone_update_edges(tau, f, t, w, rho)
            want = pu.pheromone_update_plain(tau, f, t, w, rho)
            calls += 1
            if n_ants == 1:
                assert torch.equal(got, want), (n_ants, rho)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert ops.launch_counts()["pheromone_update"] == calls


@pytest.mark.cuda
def test_pheromone_update_edges_kernel_edge_cases():
    """E = 0 (pure evaporation), n0 = 1, endpoints -1 and past the matrix
    on both sides, and streams that are not 16-byte aligned: each bitwise
    the plain version where a cell gets at most one deposit."""
    dev = cuda_device()
    rng = np.random.default_rng(11)
    tau = torch.tensor((rng.random((1002, 1002)) * 1e-2).astype(np.float32),
                       device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    empty_w = torch.zeros(0, device=dev)
    assert torch.equal(pu.pheromone_update(tau, none, none, empty_w, 0.5),
                       pu.pheromone_update_plain(tau, none, none, empty_w,
                                                 0.5))
    row = torch.tensor((rng.random((1, 777)) * 1e-2).astype(np.float32),
                       device=dev)
    cols = torch.tensor(rng.permutation(777)[:500].astype(np.int32),
                        device=dev)
    zeros = torch.zeros_like(cols)
    wr = torch.tensor(rng.random(500).astype(np.float32), device=dev)
    assert torch.equal(pu.pheromone_update(row, zeros, cols, wr, 0.1),
                       pu.pheromone_update_plain(row, zeros, cols, wr, 0.1))
    f, t, w = (torch.tensor(a, device=dev)
               for a in _edge_stream(rng, 1002, 1))
    bad_f, bad_t = f.clone(), t.clone()
    bad_f[::7] = -1
    bad_f[3::11] = 1002
    bad_t[5::13] = -1
    bad_t[6::17] = 5000
    assert torch.equal(pu.pheromone_update(tau, bad_f, bad_t, w, 0.5),
                       pu.pheromone_update_plain(tau, bad_f, bad_t, w, 0.5))
    for lo in (1, 2, 3):  # views whose data is not 16-byte aligned
        assert torch.equal(
            pu.pheromone_update(tau, f[lo:], t[lo:], w[lo:], 0.5),
            pu.pheromone_update_plain(tau, f[lo:], t[lo:], w[lo:], 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n_ants", [1, 64])
def test_pheromone_update_kernel_repeated_cities(n_ants):
    """Tours that repeat a city (construction over an int8 store can emit
    them) take the kernel's exact path: bitwise the CPU plain composition
    and the same from launch to launch, one instance alone or one slot of
    a stack of three, the others' row-owner path unchanged."""
    dev = cuda_device()
    n, n_act = 501, 480
    rng = np.random.default_rng(n_ants + 3)
    tau = torch.tensor((rng.random((3, n, n)) * 1e-2).astype(np.float32),
                       device=dev)
    tours = np.stack([np.stack([np.concatenate([rng.permutation(n_act),
                                                np.arange(n_act, n)])
                                for _ in range(n_ants)])
                      for _ in range(3)]).astype(np.int32)
    for a in range(n_ants):
        at = rng.choice(np.arange(1, n_act), size=5, replace=False)
        tours[1, a, at] = tours[1, a, 0]
    tours = torch.tensor(tours, device=dev)
    w = torch.tensor((rng.random((3, n_ants)) * 1e-2).astype(np.float32),
                     device=dev)
    n_arr = torch.full((3,), n_act, dtype=torch.int32, device=dev)
    got = ops.pheromone_update(tau, tours, w, 0.1, n_arr)
    again = ops.pheromone_update(tau, tours, w, 0.1, n_arr)
    assert torch.equal(got, again)
    for b in range(3):
        want = ops.pheromone_update(tau[b].cpu(), tours[b].cpu(),
                                    w[b].cpu(), 0.1, n_act)
        assert torch.equal(got[b].cpu(), want), b
        solo = ops.pheromone_update(tau[b], tours[b], w[b], 0.1, n_act)
        assert torch.equal(solo, got[b]), b


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
    for construction, launched, per_it in (
            ("data_parallel", "fused_walk", 1), ("pallas", "tour_select", 59)):
        cfg = aco.ACOConfig(variant="mmas", iterations=4, seed=5,
                            use_pallas=True, construction=construction)
        ops.reset_launch_counts()
        gpu = aco.run(inst, cfg, device=dev)
        assert ops.launch_counts()[launched] == 4 * per_it
        assert ops.launch_counts()["fused_select"] == 0
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
            assert counts["fused_walk_quant"] == 3
            assert counts["fused_select_quant"] == 0
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "counter", "padded", "window"])
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_fused_walk_kernel_bitwise(tau_dtype, case):
    """One fused_walk launch against the plain walk on the card (every step
    through the full draw and fused_select_plain): the cities bitwise in
    all three modes; iroulette and greedy also against the CPU.  n = 301
    (rows start off 16-byte boundaries), m = 40; padded: 293 real cities;
    window: the walk's last 60 steps from a random mid-walk state (the
    route's shapes are in chip_smoke.py)."""
    dev = cuda_device()
    n, m = 301, 40
    n_actual = 293 if case == "padded" else None
    draw = "counter" if case == "counter" else "packed"
    rng = np.random.default_rng(n + m)
    tau = torch.tensor((rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32),
                       device=dev)
    eta = torch.tensor((1.0 / (rng.random((n, n)) * 100 + 1)).astype(
        np.float32), device=dev)
    scale = None
    if tau_dtype != "fp32":
        qt = quant.quantise(tau, tau_dtype,
                            key=torch.tensor([0, n], device=dev))
        tau, scale = qt.q, (qt.scale if tau_dtype == "int8" else None)
    key = torch.tensor([3, 11], device=dev)
    visited, first = None, 1
    if case == "window":
        visited = torch.tensor(rng.random((m, n)) < 0.8, device=dev)
        first = n - 60
    start = torch.tensor(rng.integers(0, n_actual or n, m).astype(np.int32),
                         device=dev)
    for mode in MODES:
        ops.reset_launch_counts()
        got = ops.fused_walk(tau, eta, start, key, 1.0, 2.0, n_actual, mode,
                             draw, scale, visited, first)
        name = "fused_walk" if tau_dtype == "fp32" else "fused_walk_quant"
        assert ops.launch_counts()[name] == 1
        want = fs.fused_walk_plain(tau, eta, start, key, 1.0, 2.0, n_actual,
                                   mode, draw, scale, visited, first)
        assert torch.equal(got, want), mode
        if mode == "gumbel":
            continue
        cpu = [None if x is None else x.cpu()
               for x in (tau, eta, start, key, scale, visited)]
        want_c = fs.fused_walk_plain(cpu[0], cpu[1], cpu[2], cpu[3], 1.0,
                                     2.0, n_actual, mode, draw, cpu[4],
                                     cpu[5], first)
        assert torch.equal(got.cpu(), want_c), (mode, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(variant="mmas"),
                                dict(variant="as", tau_dtype="int8",
                                     local_search="2opt", ls_rounds=6)])
def test_batched_kernel_route_on_card_equals_cpu_and_solo(kw):
    """The batched engine on the card: every slot of a masked bucket is
    bitwise its solo run, and the whole stack bitwise the CPU's."""
    from repro_torch import tree
    from repro_torch.solver import engine
    dev = cuda_device()
    insts = [tsp.random_instance(n, seed=n) for n in (40, 57, 64)]
    cfg = aco.ACOConfig(use_pallas=True, iterations=5, **kw)
    got, _ = engine.solve_instances(insts, cfg, iterations=[5, 3, 4],
                                    n_pad=64, device=dev)
    want, _ = engine.solve_instances(insts, cfg, iterations=[5, 3, 4],
                                     n_pad=64, device="cpu")
    for a, b in zip(tree.flatten(got), tree.flatten(want)):
        assert torch.equal(a.cpu(), b)
    for i, inst in enumerate(insts):
        solo, _ = engine.solve_instances([inst], cfg,
                                         iterations=[[5, 3, 4][i]],
                                         seeds=[cfg.seed + i], n_pad=64,
                                         device=dev)
        for a, b in zip(tree.flatten(tree.index(got, i)),
                        tree.flatten(tree.index(solo, 0))):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(tmp_path):
    """A state saved from the card restores bitwise onto the template's
    device (bf16 payload as raw bits)."""
    from repro_torch import checkpoint, tree
    dev = cuda_device()
    inst = tsp.random_instance(30, seed=1)
    st = aco.run(inst, aco.ACOConfig(iterations=2, tau_dtype="bf16",
                                     use_pallas=True), device=dev)
    path = str(tmp_path / "c.npz")
    checkpoint.save_pytree(path, st, step=2)
    rest = checkpoint.load_pytree(path, tree.map(torch.zeros_like, st))
    for a, b in zip(tree.flatten(st), tree.flatten(rest)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)


def _stack_walk_operands(tau_dtype, dev, n=304, m=40, b=3):
    """A (B, n, n) stack whose instances start on 16-byte boundaries."""
    rng = np.random.default_rng(n + b)
    tau = torch.tensor((rng.random((b, n, n)) * 1e-2 + 1e-3).astype(
        np.float32), device=dev)
    eta = torch.tensor((1.0 / (rng.random((b, n, n)) * 100 + 1)).astype(
        np.float32), device=dev)
    scale = None
    if tau_dtype != "fp32":
        qt = quant.quantise(tau, tau_dtype)
        tau, scale = qt.q, (qt.scale if tau_dtype == "int8" else None)
    n_act = (n, n - 14, n - 54)
    start = torch.tensor(np.stack([rng.integers(0, na, m) for na in n_act])
                         .astype(np.int32), device=dev)
    keys = torch.tensor([[3, 11 + i] for i in range(b)], device=dev)
    return tau, scale, eta, start, keys, n_act


@pytest.mark.cuda
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_batched_walk_kernel_bitwise_single_launches(tau_dtype):
    """One launch over a stack of three instances (mixed n_actual, the
    middle one inactive) is bitwise three single launches and the plain
    walks on the card, in all three modes; the inactive instance costs no
    walk and its rows stay zero."""
    dev = cuda_device()
    tau, scale, eta, start, keys, n_act = _stack_walk_operands(tau_dtype,
                                                               dev)
    na_dev = torch.tensor(n_act, dtype=torch.int32, device=dev)
    name = "fused_walk" if tau_dtype == "fp32" else "fused_walk_quant"
    for mode in MODES:
        ops.reset_launch_counts()
        got = ops.fused_walk(tau, eta, start, keys, 1.0, 2.0, na_dev, mode,
                             tau_scale=scale, active=(True, False, True))
        assert ops.launch_counts()[name] == 1
        assert ops.slot_launch_counts()[name] == 2
        assert not got[1].any()
        want = fs.fused_walk_plain(tau, eta, start, keys, 1.0, 2.0, na_dev,
                                   mode, tau_scale=scale,
                                   active=(True, False, True))
        assert torch.equal(got, want), mode
        for b in (0, 2):
            one = ops.fused_walk(tau[b], eta[b], start[b], keys[b], 1.0, 2.0,
                                 n_act[b], mode,
                                 tau_scale=None if scale is None
                                 else scale[b])
            assert torch.equal(got[b], one), (mode, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [40, 1])
def test_batched_update_kernel_bitwise_single_launches(m):
    """One tours-driven update over a stack (mixed n_actual, one inactive
    instance) is bitwise single launches and the plain updates on the CPU
    (the card's ``index_add_`` sums a cell's deposits in atomic order)."""
    dev = cuda_device()
    n, b = 304, 3
    rng = np.random.default_rng(m)
    n_act = (n, n - 14, n - 54)
    tau = torch.tensor(rng.random((b, n, n)).astype(np.float32), device=dev)
    tours = torch.tensor(np.stack([np.stack([np.concatenate(
        [rng.permutation(na), np.arange(na, n)]) for _ in range(m)])
        for na in n_act]).astype(np.int32), device=dev)
    w = torch.tensor(rng.random((b, m)).astype(np.float32), device=dev)
    na_dev = torch.tensor(n_act, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.pheromone_update(tau, tours, w, 0.1, na_dev,
                               active=(True, False, True))
    assert ops.launch_counts()["pheromone_update_tours"] == 1
    assert ops.slot_launch_counts()["pheromone_update_tours"] == 2
    want = pu.pheromone_update_tours_plain(tau.cpu(), tours.cpu(), w.cpu(),
                                           0.1, na_dev.cpu(),
                                           active=(True, False, True))
    for i in (0, 2):
        assert torch.equal(got[i].cpu(), want[i]), i
        assert torch.equal(got[i], ops.pheromone_update(
            tau[i], tours[i], w[i], 0.1, n_act[i])), i


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(variant="mmas"),
                                dict(variant="acs", tau_dtype="bf16",
                                     metrics=True)])
def test_batched_engine_launches_once_per_engine_iteration(kw):
    """run_batch on the fused route: one walk and one update launch per
    engine iteration; slot-launches equal the slot-iterations; the stack
    bitwise the CPU's."""
    from repro_torch import tree
    from repro_torch.solver import engine
    dev = cuda_device()
    insts = [tsp.random_instance(n, seed=n) for n in (40, 57, 64, 33)]
    cfg = aco.ACOConfig(use_pallas=True, iterations=5, **kw)
    its = [5, 3, 4, 1]
    ops.reset_launch_counts()
    got, _ = engine.solve_instances(insts, cfg, iterations=its, n_pad=64,
                                    device=dev)
    walk = "fused_walk" if cfg.tau_dtype == "fp32" else "fused_walk_quant"
    assert ops.launch_counts()[walk] == 5
    assert ops.launch_counts()["pheromone_update_tours"] == 5
    assert ops.slot_launch_counts()[walk] == sum(its)
    assert ops.slot_launch_counts()["pheromone_update_tours"] == sum(its)
    want, _ = engine.solve_instances(insts, cfg, iterations=its, n_pad=64,
                                     device="cpu")
    for a, b in zip(tree.flatten(got), tree.flatten(want)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("tau_dtype", ["fp32", "int8", "bf16"])
def test_batched_sparse_walk_kernel_bitwise_single_launches(tau_dtype):
    """One sparse_walk launch over a stack of four instances in a bucket of
    304 (mixed n_actual, the second one inactive) is bitwise four single
    launches and the plain walks on the card (cities, lengths, fallback
    counts, tabu rows), in all three modes and both draws; the inactive
    instance costs no walk and its rows stay as they were."""
    from repro_torch import tree
    dev = cuda_device()
    operands = ss.stack_walk_operands((304, 271, 233, 290), 304, 32, 8, 4,
                                      tau_dtype, dev, seed=5)
    problem, tau, ovf_city, ovf_tau, start, visited, keys = operands
    na_dev = torch.tensor(problem.n_actual, dtype=torch.int32, device=dev)
    active = (True, False, True, True)
    for mode in MODES:
        for draw in ("packed", "counter"):
            vis_k, vis_p = visited.clone(), visited.clone()
            ops.reset_launch_counts()
            got = ops.sparse_walk(problem, tau, ovf_city, ovf_tau, start,
                                  vis_k, keys, mode, 1.0, 2.0, "EUC_2D", draw,
                                  na_dev, active)
            assert ops.launch_counts()["sparse_walk"] == 1
            assert ops.slot_launch_counts()["sparse_walk"] == 3
            assert not got[0][1].any() and torch.equal(vis_k[1], visited[1])
            want = ss.sparse_walk_plain(problem, tau, ovf_city, ovf_tau,
                                        start, vis_p, keys, mode, 1.0, 2.0,
                                        "EUC_2D", draw, na_dev, active)
            for g, w, what in zip(got, want, ("cities", "lengths",
                                              "fallbacks")):
                assert torch.equal(g, w), (mode, draw, what)
            assert torch.equal(vis_k, vis_p), (mode, draw)
            assert int(got[2].sum()) > 0
            for b in (0, 2, 3):
                vis_1 = visited[b].clone()
                one = ops.sparse_walk(
                    problem.slot(b, problem.n_actual[b]), tree.index(tau, b),
                    ovf_city[b], tree.index(ovf_tau, b), start[b], vis_1,
                    keys[b], mode, 1.0, 2.0, "EUC_2D", draw,
                    problem.n_actual[b])
                for g, w in zip(got, one):
                    assert torch.equal(g[b], w), (mode, draw, b)
                assert torch.equal(vis_k[b], vis_1), (mode, draw, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(variant="mmas", metrics=True),
                                dict(variant="acs", tau_dtype="int8")])
def test_batched_sparse_engine_walks_once_per_engine_iteration(kw):
    """run_batch(kind="sparse") on the kernel route: one sparse_walk launch
    per engine iteration, slot-launches equal to the slot-iterations, the
    stack bitwise the CPU's (one deposit tour: no atomic sums)."""
    from repro_torch import tree
    from repro_torch.solver import engine
    dev = cuda_device()
    insts = [tsp.random_instance(n, seed=n) for n in (120, 97, 128)]
    cfg = aco.ACOConfig(sparse=True, sparse_k=6, m=16, use_pallas=True,
                        iterations=5, rho=0.1, **kw)
    its = [5, 3, 4]
    ops.reset_launch_counts()
    got, _ = engine.solve_instances(insts, cfg, iterations=its, device=dev)
    assert ops.launch_counts()["sparse_walk"] == 5
    assert ops.slot_launch_counts()["sparse_walk"] == sum(its)
    want, _ = engine.solve_instances(insts, cfg, iterations=its,
                                     device="cpu")
    for a, b in zip(tree.flatten(got), tree.flatten(want)):
        assert torch.equal(a.cpu(), b)


def _stack_choice_operands(dev, n, b=3):
    rng = np.random.default_rng(n + 7 * b)
    tau = torch.tensor((rng.random((b, n, n)) * 1e-2 + 1e-3).astype(
        np.float32), device=dev)
    eta = torch.tensor((1.0 / (rng.random((b, n, n)) * 100 + 1)).astype(
        np.float32), device=dev)
    n_act = (n, n - 14, n - 54)
    return tau, eta, n_act, torch.tensor(n_act, dtype=torch.int32,
                                         device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [304, 301])       # float4 and scalar passes
def test_batched_choice_info_kernel_bitwise_single_launches(n):
    """One Choice launch over a stack (mixed n_actual, the middle instance
    inactive) is bitwise the single launches and the plain version."""
    dev = cuda_device()
    tau, eta, n_act, na_dev = _stack_choice_operands(dev, n)
    active = (True, False, True)
    for alpha, beta in ((1.0, 2.0), (2.0, 3.0)):
        ops.reset_launch_counts()
        got = ops.choice_info(tau, eta, alpha, beta, na_dev, active)
        assert ops.launch_counts()["choice_info"] == 1
        assert ops.slot_launch_counts()["choice_info"] == 2
        want = ci.choice_info_plain(tau, eta, alpha, beta, na_dev, active)
        for b in (0, 2):
            assert torch.equal(got[b], want[b]), (alpha, b)
            assert torch.equal(got[b], ci.choice_info(
                tau[b], eta[b], alpha, beta, n_act[b])), (alpha, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_batched_tour_select_kernel_bitwise_single_launches(mode):
    """One selection launch over (3, 40, n) rows (mixed n_actual, the
    first instance inactive: its ants pick 0) is bitwise the single
    launches and the plain version."""
    dev = cuda_device()
    n, m = 304, 40
    tau, eta, n_act, na_dev = _stack_choice_operands(dev, n)
    rng = np.random.default_rng(m)
    rows = ci.choice_info_plain(tau, eta, 1.0, 2.0)[:, :m].contiguous()
    visited = torch.tensor(rng.random((3, m, n)) < 0.5, device=dev)
    rand = torch.tensor((rng.random((3, m, n)) * (1 - 1e-6) + 1e-6).astype(
        np.float32), device=dev)
    active = (False, True, True)
    ops.reset_launch_counts()
    got = ops.tour_select(rows, visited, rand, mode, na_dev, active)
    assert ops.launch_counts()["tour_select"] == 1
    assert ops.slot_launch_counts()["tour_select"] == 2
    assert not got[0].any()
    assert torch.equal(got, ts.tour_select_plain(rows, visited, rand, mode,
                                                 na_dev, active))
    for b in (1, 2):
        assert torch.equal(got[b], ts.tour_select(rows[b], visited[b],
                                                  rand[b], mode, n_act[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["best", "first"])
def test_two_opt_best_fold_bitwise_single_launches(mode):
    """A stack's 2-opt moves folded into (B * m, M) rows: one launch is
    bitwise one launch per instance and the plain reduction."""
    from repro_torch.solver import batch
    dev = cuda_device()
    ns, m = (304, 290, 250, 301), 40
    bt = batch.make_batch([tsp.random_instance(n, seed=n) for n in ns], 304,
                          nn_k=16, device=dev)
    rng = np.random.default_rng(3)
    tours = torch.tensor(np.stack([np.stack([np.concatenate(
        [rng.permutation(n), np.arange(n, 304)]) for _ in range(m)])
        for n in ns]).astype(np.int32), device=dev)
    na_dev = torch.tensor(ns, dtype=torch.int32, device=dev)
    operands = localsearch._two_opt_operands(bt.problem.dist, bt.problem.nn,
                                         tours, na_dev)
    flat = [x.reshape(len(ns) * m, -1) for x in operands[:5]]
    got = to.two_opt_best(*flat, thr=1e-3, mode=mode)
    want = to.two_opt_best_plain(*flat, thr=1e-3, mode=mode)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for b in range(len(ns)):
        one = to.two_opt_best(*(x[b * m:(b + 1) * m].contiguous()
                                for x in flat), thr=1e-3, mode=mode)
        assert torch.equal(got[0][b * m:(b + 1) * m], one[0]), b
        assert torch.equal(got[1][b * m:(b + 1) * m], one[1]), b


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(variant="as", construction="pallas"),
                                dict(variant="mmas", local_search="2opt",
                                     ls_rounds=6, ls_every=2)])
def test_batched_pallas_and_local_search_step_the_stack(kw):
    """run_batch on the ``pallas`` construction (one ``choice_info`` launch
    and max n_actual - 1 ``tour_select`` launches per engine iteration) and
    with local search (one ``two_opt_best`` launch per round of the
    stack): the stack bitwise the CPU's and every slot its solo run."""
    from repro_torch import tree
    from repro_torch.solver import engine
    dev = cuda_device()
    insts = [tsp.random_instance(n, seed=n) for n in (40, 57, 64, 33)]
    cfg = aco.ACOConfig(use_pallas=True, iterations=4, **kw)
    its = [4, 3, 4, 2]
    ops.reset_launch_counts()
    localsearch.improve.rounds = 0
    got, _ = engine.solve_instances(insts, cfg, iterations=its, n_pad=64,
                                    device=dev)
    counts = ops.launch_counts()
    if cfg.construction == "pallas":
        assert counts["choice_info"] == 4
        assert counts["tour_select"] == 4 * 63
    else:
        assert counts["fused_walk"] == 4
        assert counts["two_opt_best"] == localsearch.improve.rounds > 0
    want, _ = engine.solve_instances(insts, cfg, iterations=its, n_pad=64,
                                     device="cpu")
    for a, b in zip(tree.flatten(got), tree.flatten(want)):
        assert torch.equal(a.cpu(), b)
    for i, inst in enumerate(insts):
        solo, _ = engine.solve_instances([inst], cfg, iterations=[its[i]],
                                         seeds=[cfg.seed + i], n_pad=64,
                                         device=dev)
        for a, b in zip(tree.flatten(tree.index(got, i)),
                        tree.flatten(tree.index(solo, 0))):
            assert torch.equal(a, b)


GRAPH_CASES = [
    pytest.param(dict(variant="mmas", metrics=True), "dense", id="mmas"),
    pytest.param(dict(variant="as", tau_dtype="int8"), "dense",
                 id="as-int8"),
    pytest.param(dict(variant="acs", tau_dtype="bf16"), "dense",
                 id="acs-bf16"),
    pytest.param(dict(variant="mmas", sparse=True, sparse_k=8, m=16),
                 "sparse", id="sparse-mmas"),
]


def _graph_case(kw, kind, dev):
    from repro_torch.solver import batch, engine
    cfg = aco.ACOConfig(use_pallas=True, seed=0, **kw)
    insts = [tsp.random_instance(n, seed=n) for n in (40, 64, 50, 33)]
    if kind == "sparse":
        b = batch.make_sparse_batch(insts, cfg.sparse_k, 64, device=dev)
        init = lambda: engine.init_sparse_states(  # noqa: E731
            insts, cfg, [0, 1, 2, 3], 64, dev)
        return cfg, b.problem, b.ewt, init
    b = batch.make_batch(insts, 64, cfg.nn_k, device=dev)
    init = lambda: engine.init_states(  # noqa: E731
        insts, cfg, [0, 1, 2, 3], 64, device=dev)
    return cfg, b.problem, "EUC_2D", init


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kind", GRAPH_CASES)
def test_graph_replay_bitwise_eager(kw, kind):
    """A warmed program on the card (static buffers, the all-active CUDA
    graph from the warm, the partly active patterns' graphs captured at
    their second sight) is bitwise the eager engine in every field, in
    place and not."""
    from repro_torch import tree
    from repro_torch.solver import engine
    from repro_torch.solver.programs import ProgramCache
    cfg, problem, ewt, init = _graph_case(kw, kind, cuda_device())
    budgets = [3, 5, 4, 5]
    want = engine.run_batch(problem, init(), budgets, cfg, 5, kind=kind,
                            ewt=ewt)
    pc = ProgramCache()
    for donate in (False, True):
        pc.warm([64], 4, cfg, 5, donate=donate, kind=kind,
                device=cuda_device())
    for donate in (False, False, True, True):
        got = engine.run_batch(problem, init(), budgets, cfg, 5, kind=kind,
                               ewt=ewt, donate=donate, programs=pc)
        for a, b in zip(tree.flatten(want), tree.flatten(got)):
            assert torch.equal(a, b)
    st = pc.stats()
    assert st["hits"] == 4 and st["misses"] == 0 and not st["warm_errors"]
    for sig in st["signatures"]:
        assert not sig["eager"] and sig["pool_bytes"] >= 0
        assert sig["patterns"] == ["all", "0111", "0101"]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kind", GRAPH_CASES[:1] + GRAPH_CASES[3:])
def test_graph_replay_counts_its_launches(kw, kind):
    """A capture records its launches instead of counting them, and each
    replay adds them: a warmed call counts what the eager call counts."""
    from repro_torch.solver import engine
    from repro_torch.solver.programs import ProgramCache
    cfg, problem, ewt, init = _graph_case(kw, kind, cuda_device())
    budgets = [3, 5, 4, 5]
    ops.reset_launch_counts()
    engine.run_batch(problem, init(), budgets, cfg, 5, kind=kind, ewt=ewt)
    want = ops.launch_counts()
    pc = ProgramCache()
    pc.warm([64], 4, cfg, 5, kind=kind, device=cuda_device())
    prog = next(iter(pc._programs.values()))
    assert sum(n for n, _ in prog.graphs[None].launches.values()) > 0
    for _ in range(2):
        ops.reset_launch_counts()
        engine.run_batch(problem, init(), budgets, cfg, 5, kind=kind,
                         ewt=ewt, programs=pc)
        assert ops.launch_counts() == want
    assert len(prog.graphs) == 3


@pytest.mark.cuda
def test_background_warm_beside_a_synchronising_thread():
    """A warm on a background thread captures no graph (the serving
    thread's device-wide synchronisations must not meet a capture): the
    serving thread keeps running and synchronising meanwhile, then its
    first warmed run captures the all-active graph, bitwise eager."""
    from repro_torch import tree
    from repro_torch.solver import engine
    from repro_torch.solver.programs import ProgramCache
    cfg, problem, ewt, init = _graph_case(dict(variant="mmas"), "dense",
                                          cuda_device())
    budgets = [2, 2, 2, 2]
    want = engine.run_batch(problem, init(), budgets, cfg, 2)
    pc = ProgramCache()
    t = pc.warm([64], 4, cfg, 2, device=cuda_device(), background=True)
    while t.is_alive():
        engine.run_batch(problem, init(), budgets, cfg, 2)
        torch.cuda.synchronize()
    pc.wait()
    prog = next(iter(pc._programs.values()))
    assert prog.graphs == {} and not pc.stats()["warm_errors"]
    got = engine.run_batch(problem, init(), budgets, cfg, 2, programs=pc)
    assert list(prog.graphs) == [None]
    for a, b in zip(tree.flatten(want), tree.flatten(got)):
        assert torch.equal(a, b)


# ------------------------------------------------ the paper's strategy ladder

LADDER = ("task_baseline", "task_choice", "nn_list", "nn_list_eager")
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", LADDER)
def test_ladder_construction_on_card_equals_cpu(method, use_pallas):
    """Each ladder construction, AS over 3 iterations at n = 100: best tour
    and length bitwise card == CPU, tau within rtol 1e-5 / atol 1e-7 (the
    card's update sums a cell's deposits in another order); on the kernel
    route one ``choice_info`` and one update launch an iteration, no
    ``choice_info`` for ``task_baseline``."""
    dev = cuda_device()
    inst = tsp.random_instance(100, seed=4)
    cfg = aco.ACOConfig(iterations=3, seed=2, construction=method,
                        use_pallas=use_pallas)
    ops.reset_launch_counts()
    gpu = aco.run(inst, cfg, device=dev)
    counts = ops.launch_counts()
    reads_choice = method != "task_baseline"
    assert counts["choice_info"] == (3 if use_pallas and reads_choice
                                     else 0)
    assert counts["pheromone_update_tours"] == (3 if use_pallas else 0)
    cpu = aco.run(inst, cfg, device="cpu")
    assert torch.equal(gpu.best_tour.cpu(), cpu.best_tour)
    assert torch.equal(gpu.best_len.cpu(), cpu.best_len)
    np.testing.assert_allclose(gpu.tau.cpu().numpy(), cpu.tau.numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["scatter", "reduction", "s2g",
                                      "s2g_tiled", "onehot"])
def test_ladder_deposits_on_card(strategy):
    """n = 100: one tour's deposit bitwise card == CPU; 100 ants' within
    rtol 1e-5 / atol 1e-7 of the CPU and of the card's ``scatter`` (so no
    TF32 product slipped into the s2g blocks); a 3-iteration MMAS colony
    with the strategy bitwise card == CPU."""
    from repro_torch.core import pheromone
    dev = cuda_device()
    gen = torch.Generator().manual_seed(3)
    tours = torch.stack([torch.randperm(100, generator=gen)
                         for _ in range(100)]).to(torch.int32)
    w = 1.0 / (torch.rand(100, generator=gen) * 4e3 + 1e3)
    one = pheromone.deposit(100, tours[:1].to(dev), w[:1].to(dev), strategy,
                            32)
    assert torch.equal(one.cpu(), pheromone.deposit(100, tours[:1], w[:1],
                                                    strategy, 32))
    many = pheromone.deposit(100, tours.to(dev), w.to(dev), strategy, 32)
    ref = pheromone.deposit(100, tours.to(dev), w.to(dev), "scatter")
    np.testing.assert_allclose(many.cpu().numpy(), ref.cpu().numpy(), **TOL)
    np.testing.assert_allclose(
        many.cpu().numpy(),
        pheromone.deposit(100, tours, w, strategy, 32).numpy(), **TOL)
    inst = tsp.random_instance(100, seed=5)
    cfg = aco.ACOConfig(variant="mmas", iterations=3, seed=1,
                        deposit=strategy, deposit_tile=32)
    gpu = aco.run(inst, cfg, device=dev)
    cpu = aco.run(inst, cfg, device="cpu")
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b), strategy


@pytest.mark.cuda
def test_placement_on_card_equals_cpu():
    """``placement.solve`` on the card: the CPU's best assignment and the
    cost within rtol 1e-6 (the loads are the same float32 adds on both,
    so they are expected to be equal)."""
    from repro_torch.core import placement
    rng = np.random.RandomState(1)
    prob = placement.PlacementProblem(
        layer_costs=tuple(np.exp(rng.normal(0, 1.0, size=32)) * 10),
        edge_traffic=(1.0,) * 32, n_stages=4, comm_lambda=0.02)
    cfg = placement.PlacementConfig(ants=32, iterations=40, seed=0)
    a_g, c_g = placement.solve(prob, cfg, device=cuda_device())
    a_c, c_c = placement.solve(prob, cfg, device="cpu")
    assert (a_g == a_c).all()
    np.testing.assert_allclose(c_g, c_c, rtol=1e-6)
    assert c_g < placement.uniform_baseline(prob)[1]
