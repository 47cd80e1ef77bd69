"""Port parity for the LM building blocks: repro_torch.models.layers against
repro.models.layers, at float32 and bfloat16.

The same seeded NumPy inputs and weights go through both, the reference's
functions compiled with ``jax.jit`` as its steps run them.  The port matches
the reference to the ulp, not bit for bit: XLA may keep a bf16 intermediate
in float32 inside a fusion and sums in its own order, PyTorch rounds each
op.  Tolerances, in ulps of the largest magnitude of the reference's output
(``torch_parity.assert_ulps_of_scale``): 8 at float32, 2 at bfloat16
(measured: at most 4 and 1).  Masks and the GQA head map are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import config as jcfg_mod  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import config as tcfg_mod  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS, assert_bitwise,  # noqa: E402
                          assert_ulps_of_scale)

DTYPES = ("float32", "bfloat16")
ULPS = {"float32": (F32_BITS, 8), "bfloat16": (BF16_BITS, 2)}
BASE = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv=2, d_head=8,
            d_ff=64, vocab=64)


def _cfgs(dtype, **kw):
    args = dict(BASE, param_dtype=dtype, compute_dtype=dtype, **kw)
    return jcfg_mod.ModelConfig(**args), tcfg_mod.ModelConfig(**args)


def _ref(fn, cfg):
    """The reference function ``fn(p, x, cfg, *rest)`` compiled for
    ``cfg``, as the reference's jitted steps run it."""
    return jax.jit(lambda p, x, *rest: fn(p, x, cfg, *rest))


def _close(want, got, dtype, what):
    bits, ulps = ULPS[dtype]
    assert_ulps_of_scale(want, got, bits, ulps, what)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


def _load(module, tree):
    """Copy a reference parameter dict into a port module."""
    with torch.no_grad():
        for name, leaf in tree.items():
            getattr(module, name).copy_(
                torch.from_numpy(np.array(leaf, np.float32)))
    return module


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_are_the_reference(norm, dtype):
    jc, tc = _cfgs(dtype, norm=norm)
    rng = np.random.default_rng(1)
    xj, xt = _pair(_rand(rng, (2, 5, 32), 3.0) + 0.5, dtype)
    pj = {k: (v + jnp.asarray(_rand(rng, v.shape, 0.1))).astype(v.dtype)
          for k, v in jl.init_norm(jc, 32).items()}
    pt = _load(tl.init_norm(tc, 32, "cpu"), pj)
    assert sorted(n for n, _ in pt.named_parameters()) == sorted(pj)
    _close(_ref(jl.apply_norm, jc)(pj, xj), tl.apply_norm(pt, xt, tc), dtype, norm)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_and_mrope_are_the_reference(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(_rand(rng, (2, 5, 4, 16)), dtype)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    for theta in (10000.0, 1e6):
        _close(jl.apply_rope(xj, jnp.asarray(pos), theta),
               tl.apply_rope(xt, torch.from_numpy(pos), theta), dtype,
               f"rope theta={theta}")
    pos3 = rng.integers(0, 500, (3, 2, 5)).astype(np.int32)
    _close(jl.apply_mrope(xj, jnp.asarray(pos3), 1e6, (2, 3, 3)),
           tl.apply_mrope(xt, torch.from_numpy(pos3), 1e6, (2, 3, 3)), dtype,
           "mrope")
    toks = np.zeros((2, 5), np.int32)
    assert_bitwise(jl.positions_like(jnp.asarray(toks), 3),
                   tl.positions_like(torch.from_numpy(toks), 3), "positions")


def test_causal_mask_is_the_reference():
    for s, t, offset, window in ((6, 6, 0, 0), (6, 6, 0, 3), (1, 9, 8, 0),
                                 (1, 9, 8, 4), (4, 10, 5, 2)):
        assert_bitwise(jl.causal_mask(s, t, offset, window),
                       tl.causal_mask(s, t, offset, window),
                       f"mask {s, t, offset, window}")


def test_expand_kv_and_padded_heads_are_the_reference():
    rng = np.random.default_rng(3)
    k = _rand(rng, (2, 5, 2, 8))
    for kw, hp in ((dict(), 4), (dict(n_heads=6, attn_pad_heads=8), 8)):
        jc, tc = _cfgs("float32", **kw)
        assert_bitwise(jl._expand_kv(jnp.asarray(k), hp, jc),
                       tl._expand_kv(torch.from_numpy(k), hp, tc),
                       f"expand_kv {kw}")
        hm = jl._head_mask(jc, hp, jnp.float32)
        got = tl._head_mask(tc, hp, torch.float32)
        assert (hm is None) == (got is None)
        if hm is not None:
            assert_bitwise(hm, got, "head mask")
    # padded query heads start at exactly zero
    _, tc = _cfgs("bfloat16", n_heads=6, attn_pad_heads=8)
    p = tl.init_attention(tc, torch.Generator().manual_seed(0), "cpu")
    assert p.wq.shape == (32, 8, 8) and p.wo.shape == (8, 8, 32)
    assert not p.wq[:, 6:].any() and not p.wo[6:].any()
    assert p.wq[:, :6].abs().min() >= 0 and p.wq[:, :6].any()


def _attention_pair(dtype, **kw):
    jc, tc = _cfgs(dtype, **kw)
    pj = jl.init_attention(jax.random.PRNGKey(4), jc)
    pt = _load(tl.init_attention(tc, None, "cpu"), pj)
    return jc, tc, pj, pt


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_full_sequence_is_the_reference(dtype):
    rng = np.random.default_rng(5)
    for kw in (dict(), dict(window=3), dict(logit_softcap=2.0),
               dict(n_heads=6, attn_pad_heads=8, rope="mrope",
                    mrope_sections=(1, 1, 2))):
        jc, tc, pj, pt = _attention_pair(dtype, **kw)
        xj, xt = _pair(_rand(rng, (2, 6, 32)), dtype)
        pos = np.arange(6, dtype=np.int32)[None]
        oj, cj = _ref(jl.attention, jc)(pj, xj, jnp.asarray(pos))
        ot, ct = tl.attention(pt, xt, tc, torch.from_numpy(pos))
        assert cj is None and ct is None
        _close(oj, ot, dtype, f"full sequence {kw}")


def _cache_pair(rng, dtype, b, t, kv, dh, length):
    k = _rand(rng, (b, t, kv, dh))
    v = _rand(rng, (b, t, kv, dh))
    (kj, kt), (vj, vt) = _pair(k, dtype), _pair(v, dtype)
    return ({"k": kj, "v": vj, "len": jnp.asarray(length, jnp.int32)},
            {"k": kt, "v": vt, "len": torch.tensor(length, dtype=torch.int32)})


def _compare_cache(cj, ct, dtype, what):
    _close(cj["k"], ct["k"], dtype, what + " k")
    _close(cj["v"], ct["v"], dtype, what + " v")
    assert int(cj["len"]) == int(ct["len"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_linear_cache_is_the_reference(dtype):
    rng = np.random.default_rng(6)
    for kw in (dict(), dict(window=3)):
        jc, tc, pj, pt = _attention_pair(dtype, **kw)
        cache_j, cache_t = _cache_pair(rng, dtype, 2, 10, 2, 8, 4)
        ref = _ref(jl.attention, jc)
        for step in range(4, 9):
            xj, xt = _pair(_rand(rng, (2, 1, 32)), dtype)
            pos = np.full((2, 1), step, np.int32)
            oj, cache_j = ref(pj, xj, jnp.asarray(pos), cache_j)
            ot, cache_t = tl.attention(pt, xt, tc, torch.from_numpy(pos),
                                       cache_t)
            _close(oj, ot, dtype, f"decode {kw} step {step}")
            _compare_cache(cache_j, cache_t, dtype, f"cache {kw} step {step}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_ring_buffer_is_the_reference(dtype):
    """Window 4, a cache of 4 slots, 16 steps: the ring wraps 3 times."""
    rng = np.random.default_rng(7)
    jc, tc, pj, pt = _attention_pair(dtype, window=4)
    zeros = np.zeros((2, 4, 2, 8), np.float32)
    (kj, kt), (vj, vt) = _pair(zeros, dtype), _pair(zeros, dtype)
    cache_j = {"k": kj, "v": vj, "len": jnp.zeros((), jnp.int32)}
    cache_t = {"k": kt, "v": vt, "len": torch.zeros((), dtype=torch.int32)}
    ref = _ref(jl.attention, jc)
    for step in range(16):
        xj, xt = _pair(_rand(rng, (2, 1, 32)), dtype)
        pos = np.full((2, 1), step, np.int32)
        oj, cache_j = ref(pj, xj, jnp.asarray(pos), cache_j)
        ot, cache_t = tl.attention(pt, xt, tc, torch.from_numpy(pos), cache_t)
        _close(oj, ot, dtype, f"ring step {step}")
        _compare_cache(cache_j, cache_t, dtype, f"ring cache step {step}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,act", [("swiglu", "silu"), ("mlp", "relu2"),
                                      ("mlp", "gelu")])
def test_mlp_is_the_reference(kind, act, dtype):
    jc, tc = _cfgs(dtype, mlp_kind=kind, act=act)
    pj = jl.init_mlp(jax.random.PRNGKey(8), jc, 64)
    pj = {k: (v * 20).astype(v.dtype) for k, v in pj.items()}  # O(1) acts
    pt = _load(tl.init_mlp(tc, 64, None, "cpu"), pj)
    assert sorted(n for n, _ in pt.named_parameters()) == sorted(pj)
    xj, xt = _pair(_rand(np.random.default_rng(9), (2, 5, 32)), dtype)
    _close(_ref(jl.mlp, jc)(pj, xj), tl.mlp(pt, xt, tc), dtype,
           f"{kind}/{act}")
