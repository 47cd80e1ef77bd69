"""Port parity for the encoder-decoder pieces: ``sampling.normal``, the
sinusoidal positions, cross-attention, ``encode`` and
``fill_cross_caches`` (repro_torch against repro.models and
``jax.random.normal``), and whisper's weights and caches through
``convert``.

The reference runs under ``jax.jit`` (once a module and case), on its
own weights; inputs are seeded NumPy arrays.  Tolerances, in ulps of the
largest magnitude of the reference's tensor
(``torch_parity.assert_ulps_of_scale``) unless stated:

- ``sampling.normal`` against ``jax.random.normal``: every element within
  4 float32 ulps of itself (measured at most 3, about 1% of the draws
  off at all: the uniform draw is bitwise, XLA's ``erf_inv`` polynomial
  is evaluated the same way, and ``torch.log1p`` differs from XLA's CPU
  ``log1p`` by an ulp or two on some inputs);
- ``_sinusoidal`` and ``_sinusoidal_at``: 2 float32 ulps of the scale
  (measured at most 1: ``torch.sin``/``cos`` against XLA's, on the same
  angles; the powers are the C library's ``powf`` on both sides);
- cross-attention (with and without its cache), ``encode`` and the
  cross caches: 16 at float32 (measured at most 3.5), 4 at bfloat16
  (measured at most 1).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale, ulp_distance)

ARCH = "whisper_medium"
DTYPES = ("float32", "bfloat16")
TOL = {"float32": (F32_BITS, 16), "bfloat16": (BF16_BITS, 4)}
ENC_LEN, SEQ = 12, 5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _cfgs(dtype):
    changes = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_reduced(ARCH), **changes),
            dataclasses.replace(tconfigs.get_reduced(ARCH), **changes))


# ------------------------------------------------------------- the draw
@pytest.mark.parametrize("seed,shape", [(1, (4, 64, 1024)),
                                        (7, (3, 1000))])
def test_normal_is_jax_random_normal(seed, shape):
    """The serve path's draw, ``normal(fold_in(PRNGKey(seed), 1), ...)``,
    and a plain key."""
    key = jax.random.PRNGKey(seed)
    tkey = sampling.prng_key(seed)
    if len(shape) == 3:
        key, tkey = jax.random.fold_in(key, 1), sampling.fold_in(tkey, 1)
    want = np.asarray(jax.random.normal(key, shape))
    got = sampling.normal(tkey, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    d = ulp_distance(want, got)
    print(f"normal {shape}: max {d.max()} ulps, {(d > 0).mean():.3%} "
          f"of the draws differ")
    assert d.max() <= 4


# ----------------------------------------------------------- positions
@pytest.mark.parametrize("s,d", [(64, 1024), (ENC_LEN, 64)])
def test_sinusoidal_positions_are_the_references(s, d):
    """``_sinusoidal(s, d)`` (the encoder's, constant under ``jit``) and
    ``_sinusoidal_at`` of traced (B, S) positions (the decoder's)."""
    want = jax.jit(jm._sinusoidal, static_argnums=(0, 1))(s, d)
    got = tl._sinusoidal(s, d)
    assert tuple(got.shape) == (s, d) and got.dtype == torch.float32
    assert_ulps_of_scale(want, got, F32_BITS, 2, "_sinusoidal")
    pos = np.random.default_rng(s).integers(0, 4 * s, (2, 7)).astype(
        np.int32)
    want_at = jax.jit(jm._sinusoidal_at, static_argnums=1)(pos, d)
    got_at = tl._sinusoidal_at(torch.from_numpy(pos), d)
    assert_ulps_of_scale(want_at, got_at, F32_BITS, 2, "_sinusoidal_at")


# ------------------------------------------------------ cross-attention
@functools.lru_cache(maxsize=None)
def _xattn_case(dtype):
    """Attention weights (wq, wk scaled by 20 for a peaked softmax), a
    decoder input, encoder states, and the reference's cross-attention of
    both without a cache and from a cache of other keys and values."""
    jcfg, _ = _cfgs(dtype)
    p = jl.init_attention(jax.random.PRNGKey(2), jcfg)
    for name in ("wq", "wk"):
        p[name] = (p[name].astype(jnp.float32) * 20).astype(jcfg.pdtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, ENC_LEN, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 2, ENC_LEN, jcfg.n_kv,
                              jcfg.d_head)).astype(np.float32)

    def run(p, x, src, kv):
        pos = jl.positions_like(x[..., 0])
        fresh = jl.attention(p, x, jcfg, pos, None, kv_src=src,
                             is_cross=True)
        cached = jl.attention(p, x, jcfg, pos, {"k": kv[0], "v": kv[1]},
                              is_cross=True)
        return fresh, cached

    ct = jcfg.cdtype
    out = jax.jit(run)(p, jnp.asarray(x, ct), jnp.asarray(src, ct),
                       jnp.asarray(kv, ct))
    return (jax.tree.map(np.asarray, p), x, src, kv,
            jax.tree.map(lambda a: np.asarray(a, np.float32), out))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_is_the_references(dtype, cached):
    p, x, src, kv, (fresh, from_cache) = _xattn_case(dtype)
    _, tcfg = _cfgs(dtype)
    bits, ulps = TOL[dtype]
    attn = tl.init_attention(tcfg, None, "cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(attn, name).copy_(_t(leaf))
    ct = tcfg.cdtype
    xt = _t(x).to(ct)
    pos = tl.positions_like(xt[..., 0])
    with torch.inference_mode():
        if cached:
            cache = {"k": _t(kv[0]).to(ct), "v": _t(kv[1]).to(ct)}
            out, c = tl.attention(attn, xt, tcfg, pos, cache, is_cross=True)
            assert c["k"] is cache["k"] and c["v"] is cache["v"]
            want_out, want_cache = from_cache
        else:
            out, c = tl.attention(attn, xt, tcfg, pos, None,
                                  kv_src=_t(src).to(ct), is_cross=True)
            want_out, want_cache = fresh
    assert set(c) == {"k", "v"} and out.dtype == ct
    assert_ulps_of_scale(want_out, out, bits, ulps, "out")
    for leaf in ("k", "v"):
        assert_ulps_of_scale(want_cache[leaf], c[leaf], bits, ulps, leaf)


# ------------------------------------------------- encoder, cross caches
@functools.lru_cache(maxsize=None)
def _tree(dtype):
    jcfg, _ = _cfgs(dtype)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(9),
                                                   jcfg))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_fill_cross_caches_are_the_references(dtype):
    """whisper reduced (two encoder layers, LayerNorm, GELU, non-causal):
    ``encode`` of seeded frames, and the decoder's cross caches filled
    from it (in the reference's stacked layout)."""
    jcfg, tcfg = _cfgs(dtype)
    tree = _tree(dtype)
    frames = np.random.default_rng(5).standard_normal(
        (2, ENC_LEN, jcfg.d_model)).astype(np.float32)

    def run(tree, frames):
        enc = jm.encode(tree, frames, jcfg)
        caches = jm.fill_cross_caches(
            tree, jm.init_cache(jcfg, 2, 8, enc_len=ENC_LEN), enc, jcfg)
        return enc, caches

    enc, caches = jax.jit(run)(tree, frames)
    bits, ulps = TOL[dtype]
    params = convert.lm_params_from_numpy(tcfg, tree, "cpu")
    with torch.inference_mode():
        got = tm.encode(params, _t(frames), tcfg)
        assert got.dtype == tcfg.cdtype
        tc = tm.fill_cross_caches(
            params, tm.init_cache(tcfg, 2, 8, "cpu", enc_len=ENC_LEN), got,
            tcfg)
    assert_ulps_of_scale(enc, got, bits, ulps, "encode")
    got_caches = convert.lm_cache_to_numpy(tcfg, tc)
    for i, (cw, cg) in enumerate(zip(caches["blocks"], got_caches["blocks"])):
        for leaf in ("k", "v"):
            assert_ulps_of_scale(np.asarray(cw["xattn"][leaf], np.float32),
                                 cg["xattn"][leaf], bits, ulps,
                                 f"layer {i} xattn.{leaf}")


def test_convert_round_trip_carries_the_encoder():
    """The reference's whisper tree -> the port's Model -> the reference's
    tree, every leaf back bit for bit: ``enc_blocks`` (stacked over the
    encoder's layers), ``enc_final_norm``, ``enc_in_proj`` and the
    decoder's ``ln_x``/``xattn``."""
    tree = _tree("bfloat16")
    _, tcfg = _cfgs("bfloat16")
    params = convert.lm_params_from_numpy(tcfg, tree, "cpu")
    assert len(params.enc_blocks) == tcfg.n_enc_layers
    assert params.enc_in_proj.dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(want, np.float32), got,
                                      jax.tree_util.keystr(path))


def test_cache_to_numpy_has_the_references_layout():
    """A prefilled whisper cache in the reference's layout: the same tree
    of leaves, shapes and dtypes as the reference's ``init_cache`` with
    ``enc_len`` (attn k/v/len beside xattn k/v)."""
    jcfg, tcfg = _cfgs("float32")
    want = jax.eval_shape(lambda: jm.init_cache(jcfg, 2, 9, enc_len=ENC_LEN))
    params = tm.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    frames = torch.zeros((2, ENC_LEN, tcfg.d_model))
    with torch.inference_mode():
        _, caches, enc = tm.prefill(params, torch.zeros((2, 3),
                                                        dtype=torch.int32),
                                    tcfg, 9, enc_frames=frames)
    assert tuple(enc.shape) == (2, ENC_LEN, tcfg.d_model)
    got = convert.lm_cache_to_numpy(tcfg, caches)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.shape == g.shape
        assert (g.dtype == np.int32) == (w.dtype == jnp.int32)
