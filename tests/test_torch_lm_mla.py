"""Port parity for DeepSeek-V3's Multi-head Latent Attention:
repro_torch.models.layers.mla_attention against
repro.models.layers.mla_attention, at float32 and bfloat16.

The reference's own weights (``init_attention`` with ``attn_kind="mla"``,
the norms' scales perturbed so that they are not all ones) are copied
into the port's ``MLAttention`` and the same seeded NumPy input goes
through both, the reference compiled with ``jax.jit``.  Two shapes: the
deepseek-v3 reduced one (q LoRA rank 32, kv rank 16, nope / rope / v
16 / 8 / 16, 4 heads) and the same with a dense q projection
(``q_lora_rank=0``, ``wq``).  Held: the full sequence (causal), and
decode through the latent cache from an empty one and from a cache
holding random entries: each step's output and the new ``ckv``,
``k_rope`` and ``len``.

Tolerances, in ulps of the largest magnitude of the reference's tensor
(``torch_parity.assert_ulps_of_scale``): 8 at float32, 2 at bfloat16, as
for GQA attention (tests/test_torch_lm_layers.py); measured at most 4 at
float32 and 0 at bfloat16.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import config as jcfg_mod  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import config as tcfg_mod  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale)

DTYPES = ("float32", "bfloat16")
ULPS = {"float32": (F32_BITS, 8), "bfloat16": (BF16_BITS, 2)}
MLA = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv=4, d_head=16,
           d_ff=64, vocab=64, attn_kind="mla", q_lora_rank=32,
           kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
SHAPES = {"q_lora": {}, "dense_q": dict(q_lora_rank=0)}


def _cfgs(dtype, shape):
    args = dict(MLA, param_dtype=dtype, compute_dtype=dtype, **SHAPES[shape])
    return jcfg_mod.ModelConfig(**args), tcfg_mod.ModelConfig(**args)


def _close(want, got, dtype, what):
    bits, ulps = ULPS[dtype]
    assert_ulps_of_scale(want, got, bits, ulps, what)


def _pair(x, dtype):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(dtype, shape):
    jc, _ = _cfgs(dtype, shape)
    p = jl.init_attention(jax.random.PRNGKey(6), jc)
    rng = np.random.default_rng(2)
    for norm in ("q_norm", "kv_norm"):
        if norm in p:
            p[norm] = (p[norm] + jnp.asarray(_rand(rng, p[norm].shape)
                                             * 0.1)).astype(p[norm].dtype)
    return p


def _pair_params(dtype, shape):
    jc, tc = _cfgs(dtype, shape)
    pj = _weights(dtype, shape)
    pt = tl.init_attention(tc, None, "cpu")
    assert isinstance(pt, tl.MLAttention)
    assert sorted(n for n, _ in pt.named_parameters()) == sorted(pj)
    with torch.no_grad():
        for name, leaf in pj.items():
            getattr(pt, name).copy_(torch.from_numpy(np.array(leaf,
                                                              np.float32)))
    return jc, tc, pj, pt


def _ref(cfg):
    return jax.jit(lambda p, x, pos, cache=None: jl.mla_attention(
        p, x, cfg, pos, cache))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_full_sequence_is_the_reference(shape, dtype):
    jc, tc, pj, pt = _pair_params(dtype, shape)
    xj, xt = _pair(_rand(np.random.default_rng(3), (2, 7, 64)), dtype)
    pos = np.arange(7, dtype=np.int32)[None]
    oj, cj = _ref(jc)(pj, xj, jnp.asarray(pos))
    ot, ct = tl.mla_attention(pt, xt, tc, torch.from_numpy(pos))
    assert cj is None and ct is None
    assert ot.dtype == xt.dtype and ot.shape == (2, 7, 64)
    _close(oj, ot, dtype, f"{shape} full sequence")


def _caches(rng, dtype, cfg, t, length):
    """The same latent cache for both: random entries below ``length``."""
    ckv = _rand(rng, (2, t, cfg.kv_lora_rank))
    krope = _rand(rng, (2, t, 1, cfg.qk_rope_dim))
    ckv[:, length:] = 0
    krope[:, length:] = 0
    (cj, ct), (kj, kt) = _pair(ckv, dtype), _pair(krope, dtype)
    return ({"ckv": cj, "k_rope": kj, "len": jnp.asarray(length, jnp.int32)},
            {"ckv": ct, "k_rope": kt,
             "len": torch.tensor(length, dtype=torch.int32)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("start", [0, 5])
def test_mla_decode_through_the_latent_cache_is_the_reference(shape, dtype,
                                                              start):
    jc, tc, pj, pt = _pair_params(dtype, shape)
    rng = np.random.default_rng(4 + start)
    cache_j, cache_t = _caches(rng, dtype, tc, 12, start)
    ref = _ref(jc)
    for step in range(start, start + 6):
        xj, xt = _pair(_rand(rng, (2, 1, 64)), dtype)
        pos = np.full((2, 1), step, np.int32)
        oj, cache_j = ref(pj, xj, jnp.asarray(pos), cache_j)
        ot, cache_t = tl.mla_attention(pt, xt, tc, torch.from_numpy(pos),
                                       cache_t)
        _close(oj, ot, dtype, f"{shape} decode step {step}")
        for leaf in ("ckv", "k_rope"):
            assert cache_t[leaf].dtype == xt.dtype
            _close(cache_j[leaf], cache_t[leaf], dtype,
                   f"{shape} step {step} {leaf}")
        assert int(cache_j["len"]) == int(cache_t["len"]) == step + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_is_the_reference(dtype):
    rng = np.random.default_rng(5)
    xj, xt = _pair(_rand(rng, (2, 3, 16)) * 3 + 0.5, dtype)
    sj, st = _pair(_rand(rng, (16,)), dtype)
    _close(jax.jit(jl._rms)(xj, sj), tl._rms(xt, st), dtype, "rms")


def test_init_attention_dispatches_on_attn_kind():
    _, tc = _cfgs("bfloat16", "q_lora")
    p = tl.init_attention(tc, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(p, tl.MLAttention)
    assert p.wq_b.shape == (32, 4 * 24) and p.wkv_b.shape == (16, 4 * 32)
    assert p.wkv_a.shape == (64, 16 + 8) and p.wo.shape == (4 * 16, 64)
    assert (p.q_norm == 1).all() and (p.kv_norm == 1).all()
    assert p.wq_a.dtype == torch.bfloat16 and p.wq_a.any()
    _, tc = _cfgs("float32", "dense_q")
    p = tl.init_attention(tc, None, "cpu")
    assert p.wq.shape == (64, 4 * 24) and not hasattr(p, "wq_a")
    gqa = tl.init_attention(tcfg_mod.ModelConfig(**dict(MLA,
                                                        attn_kind="gqa")),
                            None, "cpu")
    assert isinstance(gqa, tl.Attention)
