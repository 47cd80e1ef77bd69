"""The port on the GPU: each CUDA kernel against its plain PyTorch version,
and the kernel route on the card against the same colony on the CPU.

Every test here needs a CUDA device and skips without one; this file
imports no JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: selection indices and choice values bitwise (the kernels round
every operation as the plain versions do, with accurate ``logf``); the
update bitwise where each cell gets at most one deposit, rtol 1e-5 / atol
1e-7 where atomics sum several deposits in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aco, tsp  # noqa: E402
from repro_torch.kernels import choice_info as ci  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from repro_torch.kernels import tour_select as ts  # noqa: E402
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
    dev = cuda_device()
    rng = np.random.default_rng(n_ants)
    tau = torch.tensor((rng.random((n, n)) * 1e-2).astype(np.float32),
                       device=dev)
    tours = torch.tensor(np.stack([rng.permutation(n)
                                   for _ in range(n_ants)]).astype(np.int32),
                         device=dev)
    w = torch.tensor((rng.random(n_ants) * 1e-2).astype(np.float32),
                     device=dev)
    for rho in (0.5, 0.1):
        got = ops.pheromone_update(tau, tours, w, rho)
        want = ops.pheromone_update(tau.cpu(), tours.cpu(), w.cpu(), rho)
        if n_ants == 1:
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)


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
