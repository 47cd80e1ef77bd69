"""Port parity: the kernels' plain PyTorch versions against the JAX Pallas
kernels (interpret mode, as the reference's own tests run them), the ops
dispatch and the launch wrappers' refusals.

Tolerances: selection indices and choice values are bitwise, except
``gumbel``, whose ``log`` differs from XLA's by an ulp (a pick may differ
only where the two candidates' JAX scores lie within 4 ulp).  The update
is bitwise where every cell gets at most one deposit; several deposits
sum in another order (rtol 1e-5, atol 1e-7).  The CUDA kernels against
their plain versions are in tests/test_torch_cuda.py (GPU only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import choice_info as jci  # noqa: E402
from repro.kernels import fused_select as jfs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pheromone_update as jpu  # noqa: E402
from repro.kernels import tour_select as jts  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import choice_info as ci  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from repro_torch.kernels import tour_select as ts  # noqa: E402
from torch_parity import assert_bitwise, ulp_distance  # noqa: E402

MODES = ["iroulette", "greedy", "gumbel"]
_NEG_INF = np.float32(-1e30)


def _inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    tau = (rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32)
    eta = (1.0 / (rng.random((n, n)) * 100 + 1)).astype(np.float32)
    visited = rng.random((m, n)) < 0.5
    rand = (rng.random((m, n)) * (1 - 1e-6) + 1e-6).astype(np.float32)
    cur = rng.integers(0, n, m).astype(np.int32)
    return tau, eta, visited, rand, cur


def _jax_scores(rows, visited, rand, n_actual, mode):
    """The reference's transform in NumPy float32 (scores for tie checks)."""
    n = rows.shape[1]
    mask = (~visited) & (np.arange(n) < (n if n_actual is None else n_actual))
    g = -np.log(-np.log(np.clip(rand, np.float32(1e-12),
                                np.float32(1 - 1e-7))))
    return np.where((rows > 0) & mask,
                    np.log(np.maximum(rows, np.float32(1e-38))) + g,
                    _NEG_INF).astype(np.float32)


def _assert_picks(want, got, mode, scores):
    want, got = np.asarray(want), got.numpy()
    if mode != "gumbel":
        assert_bitwise(want, got, mode)
        return
    rows = np.nonzero(want != got)[0]
    d = ulp_distance(scores[rows, want[rows]], scores[rows, got[rows]])
    assert d.max(initial=0) <= 4, d


@pytest.mark.parametrize("n0,n1", [(29, 29), (73, 73), (40, 57)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 2.0), (2.0, 3.0), (1.0, 4.0)])
@pytest.mark.parametrize("n_actual", [None, 21])
def test_choice_info_plain_vs_pallas(n0, n1, alpha, beta, n_actual):
    rng = np.random.default_rng(n0 * n1)
    tau = (rng.random((n0, n1)) + 0.1).astype(np.float32)
    eta = (rng.random((n0, n1)) + 0.1).astype(np.float32)
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jci.choice_info(tau, eta, alpha, beta, na, interpret=True)
    got = ci.choice_info_plain(torch.tensor(tau), torch.tensor(eta), alpha,
                               beta, n_actual)
    assert_bitwise(want, got, "choice_info")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n,n_actual", [(8, 29, None), (13, 73, None),
                                          (11, 40, 33)])
def test_tour_select_plain_vs_pallas(mode, m, n, n_actual):
    tau, eta, visited, rand, cur = _inputs(m, n, m + n)
    rows = (tau * eta * eta)[cur]
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jts.tour_select(rows, visited, rand, mode, na, block_n=16,
                           interpret=True)
    got = ts.tour_select_plain(torch.tensor(rows), torch.tensor(visited),
                               torch.tensor(rand), mode, n_actual)
    _assert_picks(want, got, mode,
                  _jax_scores(rows, visited, rand, n_actual, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,n,n_actual", [(8, 29, None), (13, 73, None),
                                          (11, 40, 33)])
def test_fused_select_plain_vs_pallas(mode, m, n, n_actual):
    tau, eta, visited, rand, cur = _inputs(m, n, 3 * m + n)
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jfs.fused_select(tau, eta, cur, visited, rand, 1.0, 2.0, na, mode,
                            block_n=16, interpret=True)
    got = fs.fused_select_plain(torch.tensor(tau), torch.tensor(eta),
                                torch.tensor(cur), torch.tensor(visited),
                                torch.tensor(rand), 1.0, 2.0, n_actual, mode)
    rows = (tau * (eta * eta))[cur]
    _assert_picks(want, got, mode,
                  _jax_scores(rows, visited, rand, n_actual, mode))


def _edge_stream(tours, w):
    frm = tours.ravel()
    to = np.roll(tours, -1, axis=-1).ravel()
    wrep = np.repeat(w, tours.shape[1])
    return (np.concatenate([frm, to]).astype(np.int32),
            np.concatenate([to, frm]).astype(np.int32),
            np.concatenate([wrep, wrep]).astype(np.float32))


@pytest.mark.parametrize("rho", [0.5, 0.1])
@pytest.mark.parametrize("n_ants", [1, 9])
def test_pheromone_update_plain_vs_pallas(rho, n_ants):
    """One tour: every cell <= 1 deposit -> bitwise (the stream spans
    several edge blocks, as at paper scale).  Several tours: rtol 1e-5."""
    n = 37
    rng = np.random.default_rng(n_ants)
    tau = (rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32)
    tours = np.stack([rng.permutation(n) for _ in range(n_ants)])
    w = (rng.random(n_ants) * 1e-2).astype(np.float32)
    frm, to, wv = _edge_stream(tours, w)
    want = jpu.pheromone_update(tau, frm, to, wv, rho, block_e=16,
                                interpret=True)
    got = pu.pheromone_update_plain(torch.tensor(tau), torch.tensor(frm),
                                    torch.tensor(to), torch.tensor(wv), rho)
    if n_ants == 1:
        assert_bitwise(want, got, "single-deposit update")
    else:
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_pheromone_update_rectangular_and_padding():
    """A (n, n/2) column shard with `to` shifted into the shard's frame and
    -1 padded edges: out-of-range endpoints deposit nothing."""
    n = 24
    rng = np.random.default_rng(7)
    tau = (rng.random((n, n // 2)) * 1e-2).astype(np.float32)
    tours = rng.permutation(n)[None]
    frm, to, wv = _edge_stream(tours, np.float32([0.25]))
    to = to - n // 2
    frm = np.concatenate([frm, [-1, -1]]).astype(np.int32)
    to = np.concatenate([to, [-1, 3]]).astype(np.int32)
    wv = np.concatenate([wv, [5.0, 5.0]]).astype(np.float32)
    want = jpu.pheromone_update(tau, frm, to, wv, 0.5, interpret=True)
    got = pu.pheromone_update_plain(torch.tensor(tau), torch.tensor(frm),
                                    torch.tensor(to), torch.tensor(wv), 0.5)
    assert_bitwise(want, got, "rectangular update")


@pytest.mark.parametrize("n_actual", [None, 19])
def test_ops_pheromone_update_from_tours(n_actual):
    """The tours -> edge-stream wrapper against the reference's."""
    n = 25
    rng = np.random.default_rng(11)
    tau = (rng.random((n, n)) * 1e-2).astype(np.float32)
    real = n if n_actual is None else n_actual
    tours = np.stack([np.concatenate([rng.permutation(real),
                                      np.arange(real, n)])
                      for _ in range(1)]).astype(np.int32)
    w = np.float32([0.125])
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jops.pheromone_update(tau, tours, w, 0.5, n_actual=na)
    got = ops.pheromone_update(torch.tensor(tau), torch.tensor(tours),
                               torch.tensor(w), 0.5, n_actual=n_actual)
    assert_bitwise(want, got, "ops.pheromone_update")


def test_ops_cpu_tensors_use_plain_versions_and_count_nothing():
    tau, eta, visited, rand, cur = _inputs(6, 17, 1)
    T = {k: torch.tensor(v) for k, v in dict(tau=tau, eta=eta, vis=visited,
                                              rand=rand, cur=cur).items()}
    ops.reset_launch_counts()
    ops.choice_info(T["tau"], T["eta"], 1.0, 2.0)
    ops.tour_select(T["tau"][:6].contiguous(), T["vis"], T["rand"])
    ops.fused_select(T["tau"], T["eta"], T["cur"], T["vis"], T["rand"])
    ops.pheromone_update(T["tau"], T["cur"][None].to(torch.int32) % 17,
                         torch.ones(1), 0.5)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert ref.fused_select is fs.fused_select_plain
    assert ref.pheromone_update is pu.pheromone_update_plain


def test_launch_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused."""
    tau, eta, visited, rand, cur = _inputs(4, 9, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_select(torch.tensor(tau), torch.tensor(eta),
                        torch.tensor(cur), torch.tensor(visited),
                        torch.tensor(rand))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ci.choice_info(torch.tensor(tau), torch.tensor(eta))
    with pytest.raises(ValueError):
        ts.mode_code("roulette")


def test_check_kernel_route_keeps_reference_messages():
    for kw in (dict(hyper=True), dict(tau_dtype="fp16"),
               dict(hyper=True, tau_dtype="int8"),
               dict(hyper=True, masked=True)):
        with pytest.raises(jops.UnsupportedKernelRoute) as want:
            jops.check_kernel_route(**kw)
        with pytest.raises(ops.UnsupportedKernelRoute) as got:
            ops.check_kernel_route(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(), dict(masked=True), dict(tau_dtype="int8")):
        jops.check_kernel_route(**kw)
        ops.check_kernel_route(**kw)
    assert issubclass(ops.UnsupportedKernelRoute, NotImplementedError)


def test_build_digest_and_sources():
    """The build is keyed by the sources: every kernel has one."""
    names = {p.stem for p in _build.sources()}
    assert {"choice_info", "tour_select", "fused_select",
            "pheromone_update"} <= names
    assert _build.lib_path().name == "libaco_kernels.so"
    assert set(_build.SIGNATURES) == {f"aco_{k}" for k in ops.KERNELS}
