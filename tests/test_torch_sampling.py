"""Port parity: repro_torch.core.sampling against jax.random / repro.core.sampling.

Every draw is held bit for bit, except the Gumbel noise: XLA's CPU ``log``
and ``torch.log`` differ by an ulp on some inputs, so it is held ulp-close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sampling as jsamp  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from torch_parity import assert_bitwise, ulp_distance  # noqa: E402

SEEDS = [0, 7, 123456]
SHAPES = [(3,), (7, 13), (40, 37)]


def _key(seed):
    return jax.random.PRNGKey(seed), sampling.prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    kj, kt = _key(seed)
    assert_bitwise(np.asarray(kj).astype(np.int64), kt, "PRNGKey")
    for num in (2, 3):
        assert_bitwise(np.asarray(jax.random.split(kj, num)).astype(np.int64),
                       sampling.split(kt, num), f"split {num}")
    many = sampling.fold_in(kt, torch.arange(1, 12))
    for d in range(1, 12):
        want = np.asarray(jax.random.fold_in(kj, d)).astype(np.int64)
        assert_bitwise(want, sampling.fold_in(kt, d), f"fold_in {d}")
        assert_bitwise(want, many[d - 1], f"batched fold_in {d}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bitwise(seed, shape):
    kj, kt = _key(seed)
    assert_bitwise(np.asarray(jax.random.bits(kj, shape)).astype(np.int64),
                   sampling.random_bits(kt, shape), "bits")
    for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-2.5, 3.0)):
        want = jax.random.uniform(kj, shape, jnp.float32, minval=lo,
                                  maxval=hi)
        assert_bitwise(want, sampling.uniform(kt, shape, lo, hi),
                       f"uniform({lo}, {hi})")


@pytest.mark.parametrize("hi", [1, 37, 1002, 70000])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, hi):
    kj, kt = _key(seed)
    for shape in ((1,), (29,), (6, 11)):
        want = jax.random.randint(kj, shape, 0, hi, dtype=jnp.int32)
        assert_bitwise(want, sampling.randint(kt, shape, 0, hi),
                       f"randint {shape} < {hi}")


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_draws_bitwise(seed):
    """Counter mode, as the reference's jitted programs compute it."""
    kj, kt = _key(seed)
    shape = (9, 21)
    assert_bitwise(np.asarray(jsamp.counter_bits(kj, shape)).astype(np.int64),
                   sampling.counter_bits(kt, shape), "counter_bits")
    want = jax.jit(lambda k: jsamp.counter_uniform(k, shape, 1e-6, 1.0))(kj)
    assert_bitwise(want, sampling.counter_uniform(kt, shape, 1e-6, 1.0),
                   "counter_uniform")
    g = jax.jit(lambda k: jsamp.counter_gumbel(k, shape))(kj)
    np.testing.assert_allclose(np.asarray(g),
                               sampling.counter_gumbel(kt, shape).numpy(),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_ulp_close(seed, shape):
    kj, kt = _key(seed)
    want = jax.random.gumbel(kj, shape)
    got = sampling.gumbel_noise(kt, shape)
    # two logs, each within an ulp of XLA's; the outer one near 0 is where
    # the relative gap is largest
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=2e-6,
                               atol=2e-6)


def test_fma_matches_fused_multiply_add():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 200)).astype(np.float32)
    c = (rng.standard_normal((300, 200)) * 1e-3).astype(np.float32)
    for b in (np.float32(0.9), np.float32(1.0 - 1e-6), np.float32(-3.7)):
        want = jax.jit(lambda a, c: b * a + c)(a, c)
        # the port's one-rounding multiply-add, in both operand orders
        got = torch.addcmul(torch.tensor(c), torch.tensor(a), torch.tensor(b))
        assert_bitwise(want, got, f"addcmul b={b}")
        got = torch.addcmul(torch.tensor(c), torch.tensor(b), torch.tensor(a))
        assert_bitwise(want, got, f"addcmul b={b} swapped")


@pytest.mark.parametrize("draw_mode", ["packed", "counter"])
@pytest.mark.parametrize("name", ["iroulette", "greedy", "roulette"])
def test_selectors_bitwise(name, draw_mode):
    rng = np.random.default_rng(3)
    w = rng.random((17, 31)).astype(np.float32)
    w[rng.random((17, 31)) < 0.4] = 0.0
    for seed in SEEDS:
        kj, kt = _key(seed)
        want = jax.jit(lambda k, w: jsamp.get_selector(name, draw_mode)(k, w)
                       )(kj, w)
        got = sampling.get_selector(name, draw_mode)(kt, torch.tensor(w))
        assert_bitwise(want, got, f"{name}/{draw_mode} seed {seed}")


def test_gumbel_selector_agrees_off_ties():
    """Gumbel picks the reference's city unless the two candidates' JAX
    scores lie within 4 ulp (the log gap can flip such a near-tie)."""
    rng = np.random.default_rng(5)
    w = rng.random((64, 41)).astype(np.float32)
    w[rng.random((64, 41)) < 0.3] = 0.0
    kj, kt = _key(11)
    want = np.asarray(jsamp.gumbel(kj, jnp.asarray(w)))
    got = sampling.gumbel(kt, torch.tensor(w)).numpy()
    logw = np.where(w > 0, np.log(np.maximum(w, 1e-38)), -1e30)
    score = (logw + np.asarray(jax.random.gumbel(kj, w.shape))).astype(
        np.float32)
    rows = np.nonzero(want != got)[0]
    assert ulp_distance(score[rows, want[rows]],
                        score[rows, got[rows]]).max(initial=0) <= 4
    assert (want == got).mean() > 0.95


def test_unknown_draw_mode_and_selector():
    with pytest.raises(ValueError):
        sampling.get_selector("iroulette", "bogus")
    with pytest.raises(KeyError):
        sampling.get_selector("bogus")
