"""The edge-stream update's numerics on the CPU, beside the reference.

``atomic_update`` below emulates the kernel in plain NumPy float32: the
evaporation product rounded on its own, then one float32 add per edge that
lands, in any order (the card's atomics add in an order no run repeats).
Over the streams the city-sharded colony and the paper's update give it
(full matrices, column slabs with -1 padding, one tour repeated by every
ant, endpoints past the matrix on either side, E = 0, one row, E not a
multiple of the kernel's four edges a thread) it is:

- bitwise ``pheromone_update_plain`` (what a CPU tensor runs) where every
  cell gets at most one deposit, whatever the order;
- within rtol 1e-5 / atol 1e-7 of it where a cell sums several;
- held to the reference's Pallas kernel in interpret mode, as
  tests/test_torch_kernels.py holds the plain version.

The kernel itself against the plain version on the card is in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import pheromone_update as jpu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pheromone_update as pu  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402


def atomic_update(tau, frm, to, w, rho, seed):
    """The kernel's update in NumPy float32, the deposits added one at a
    time in a random order drawn from ``seed``."""
    tau = np.asarray(tau, np.float32)
    frm, to = np.asarray(frm, np.int64), np.asarray(to, np.int64)
    w = np.asarray(w, np.float32)
    n0, n1 = tau.shape
    out = np.float32(pu._decay(rho)) * tau
    lands = (frm >= 0) & (frm < n0) & (to >= 0) & (to < n1)
    for e in np.random.default_rng(seed).permutation(np.nonzero(lands)[0]):
        out[frm[e], to[e]] = np.float32(out[frm[e], to[e]] + w[e])
    return out


def _plain(tau, frm, to, w, rho):
    return pu.pheromone_update_plain(
        torch.tensor(tau), torch.tensor(frm, dtype=torch.int32),
        torch.tensor(to, dtype=torch.int32), torch.tensor(w), rho).numpy()


def _stream(rng, n, n_ants, converged=False, slab=None):
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
        c0, cols = slab
        t2 = t2 - c0
        t2 = np.where((t2 >= 0) & (t2 < cols), t2, -1)
    return (f2.astype(np.int32), t2.astype(np.int32),
            np.concatenate([wrep, wrep]).astype(np.float32))


def _bad_endpoints(rng, n0, n1):
    """A single-deposit stream with endpoints -1 and past the matrix on
    both sides, and a length that is not a multiple of four."""
    cells = rng.permutation(n0 * n1)[:n0 * n1 // 3]
    frm, to = (cells // n1).astype(np.int32), (cells % n1).astype(np.int32)
    frm[::7], frm[3::11] = -1, n0
    to[5::13], to[6::17] = -1, n1 + 40
    keep = frm.size - (frm.size % 4 == 0)
    return frm[:keep], to[:keep], rng.random(keep).astype(np.float32)


# name -> (n0, n1, ants, converged, slab)
SINGLE = {
    "full": (61, 61, 1, False, None),
    "slab": (60, 20, 1, False, (20, 20)),
    "last slab": (60, 20, 1, False, (40, 20)),
    "one row": (1, 77, 1, False, None),
}


@pytest.mark.parametrize("case", list(SINGLE))
@pytest.mark.parametrize("rho", [0.5, 0.1])
def test_single_deposits_bitwise_plain_in_any_order(case, rho):
    n0, n1, ants, conv, slab = SINGLE[case]
    rng = np.random.default_rng(n0 + n1)
    tau = (rng.random((n0, n1)) * 1e-2 + 1e-3).astype(np.float32)
    if n0 == 1:
        frm, to, w = _bad_endpoints(rng, n0, n1)
    else:
        frm, to, w = _stream(rng, n0, ants, conv, slab)
    want = _plain(tau, frm, to, w, rho)
    for seed in range(3):
        assert_bitwise(want, atomic_update(tau, frm, to, w, rho, seed),
                       f"{case} rho={rho} order {seed}")


def test_pure_evaporation_and_bad_endpoints_bitwise_plain():
    """E = 0 evaporates only; endpoints -1 and past the matrix, on either
    side, deposit nothing."""
    rng = np.random.default_rng(5)
    tau = (rng.random((41, 43)) * 1e-2).astype(np.float32)
    none = np.zeros(0, np.int32)
    assert_bitwise(_plain(tau, none, none, none.astype(np.float32), 0.5),
                   atomic_update(tau, none, none, none.astype(np.float32),
                                 0.5, 0), "E = 0")
    frm, to, w = _bad_endpoints(rng, 41, 43)
    assert_bitwise(_plain(tau, frm, to, w, 0.5),
                   atomic_update(tau, frm, to, w, 0.5, 1), "bad endpoints")


@pytest.mark.parametrize("ants,conv,slab", [(9, False, None),
                                            (61, False, None),
                                            (61, True, None),
                                            (61, False, (20, 21))])
def test_several_deposits_close_to_plain(ants, conv, slab):
    """m = n ants put two deposits on a cell on average, a converged
    stream puts all m on each of its cells; any order is within rtol 1e-5
    / atol 1e-7 of the plain version's."""
    n = 61
    rng = np.random.default_rng(ants + conv)
    n1 = n if slab is None else slab[1]
    tau = (rng.random((n, n1)) * 1e-2 + 1e-3).astype(np.float32)
    frm, to, w = _stream(rng, n, ants, conv, slab)
    want = _plain(tau, frm, to, w, 0.1)
    for seed in range(2):
        np.testing.assert_allclose(atomic_update(tau, frm, to, w, 0.1, seed),
                                   want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_ants,conv", [(1, False), (9, False), (9, True)])
def test_atomic_update_vs_pallas(n_ants, conv):
    """n = 37, the Pallas kernel over blocks of 16 edges: one tour bitwise,
    nine tours and a converged stream rtol 1e-5 / atol 1e-7."""
    n = 37
    rng = np.random.default_rng(n_ants + conv)
    tau = (rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32)
    frm, to, w = _stream(rng, n, n_ants, conv)
    want = np.asarray(jpu.pheromone_update(tau, frm, to, w, 0.1, block_e=16,
                                           interpret=True))
    got = atomic_update(tau, frm, to, w, 0.1, n_ants)
    if n_ants == 1:
        assert_bitwise(want, got, "single-deposit update")
    else:
        np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-7)


def test_atomic_update_vs_pallas_on_a_slab():
    """A (24, 12) column slab, `to` shifted into its frame, -1 padded
    edges and endpoints past it: bitwise the Pallas kernel, and the ops
    dispatch on CPU tensors (the plain version) with it, counting no
    launch."""
    n, cols = 24, 12
    rng = np.random.default_rng(7)
    tau = (rng.random((n, cols)) * 1e-2).astype(np.float32)
    frm, to, w = _stream(rng, n, 1, slab=(cols, cols))
    frm = np.concatenate([frm, [-1, -1, n, 2]]).astype(np.int32)
    to = np.concatenate([to, [-1, 3, 0, cols]]).astype(np.int32)
    w = np.concatenate([w, [5.0, 5.0, 5.0, 5.0]]).astype(np.float32)
    want = np.asarray(jpu.pheromone_update(tau, frm, to, w, 0.5,
                                           interpret=True))
    assert_bitwise(want, atomic_update(tau, frm, to, w, 0.5, 3), "slab")
    ops.reset_launch_counts()
    got = ops.pheromone_update_edges(
        torch.tensor(tau), torch.tensor(frm), torch.tensor(to),
        torch.tensor(w), 0.5)
    assert_bitwise(want, got.numpy(), "ops on CPU tensors")
    assert ops.launch_counts()["pheromone_update"] == 0
