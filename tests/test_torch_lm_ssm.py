"""Port parity for the Mamba (SSD) layer: repro_torch.models.ssm against
repro.models.ssm, and the Mamba configs' weights and caches through
``convert``.

The reference runs under one ``jax.jit`` a case (the SSD scan, the
gated norm and softplus, a whole ``mamba_forward`` with its 12-step
decode), each compiled once a module; the same seeded NumPy inputs go
through both packages.  The Mamba layer takes the reference's own
``init_mamba`` weights with ``in_proj``, ``conv_w`` and ``out_proj``
scaled by 20, so that its activations are of order one, copied into the
port's ``Mamba``; the shape is mamba2's reduced one (d 64, d_inner 128,
8 heads of 16, state 16, chunk 8) with G = 2 state groups, and 12 tokens
(the last chunk padded).

Tolerances, in ulps of the largest magnitude of the reference's tensor
(``torch_parity.assert_ulps_of_scale``):

- ``_ssd_chunked`` (float32; the three shapes of tests/test_models.py::
  test_ssd_chunked_matches_naive, with and without an initial state, G =
  2 and G = 1): 8 (measured at most 3);
- the gated norm and softplus: 4 float32 ulps (measured 1); at bf16 the
  gated norm's output within 1 bf16 ulp (measured 0.5);
- ``mamba_forward``'s full sequence and cache, and a 12-step decode and
  its final cache: 32 at float32 (measured at most 23, a decode step;
  the full sequence 3.5), 4 at bfloat16 (measured at most 1.25).  At bf16 the decode's state
  is rounded to bf16 every step, as the reference's is.  The float32
  bound is wider than the models' 16: a decode step's read-out C . h
  cancels and the gated norm then scales each token to unit RMS, so the
  matmuls' last-bit differences come out larger here (the reference's
  own decode and forward of these inputs differ by 30 float32 ulps of
  the scale).

The conv windows and silu are bitwise the reference's at bf16 (one
rounded operation after another; XLA's ``x * (1 / (1 + exp(-x)))``); the
rest differs by the matmuls' and ``exp``'s last bits.

The models' prefill against forward at bf16 (where a Mamba layer's
per-step bf16 state shows) is held in tests/test_torch_lm_model.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale, ulp_distance)

DTYPES = ("float32", "bfloat16")
TOL = {"float32": (F32_BITS, 32), "bfloat16": (BF16_BITS, 4)}
SEQ = 12
SSM_ARCHS = ("mamba2_1_3b", "jamba_1_5_large_398b")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------- the scan
@functools.lru_cache(maxsize=None)
def _ref_ssd(chunk):
    return jax.jit(functools.partial(jssm._ssd_chunked, chunk=chunk))


@pytest.mark.parametrize("s,chunk,g", [(16, 4, 2), (32, 8, 2), (24, 24, 2),
                                       (16, 4, 1)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_is_the_reference(s, chunk, g, with_h0):
    b, h, p, n = 2, 4, 8, 16
    rng = np.random.default_rng(s * 10 + chunk + g)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    y, final = _ref_ssd(chunk)(x, dt, A, B, C, D, h0=h0)
    y2, final2 = tssm._ssd_chunked(
        _t(x), _t(dt), _t(A), _t(B), _t(C), _t(D), chunk,
        None if h0 is None else _t(h0))
    assert final2.dtype == torch.float32 and final2.shape == (b, h, p, n)
    assert_ulps_of_scale(y, y2, F32_BITS, 8, "y")
    assert_ulps_of_scale(final, final2, F32_BITS, 8, "final state")


# ------------------------------------------------------ norm and softplus
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_norm_and_softplus_are_the_references(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    z = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    scale = (1 + rng.standard_normal(32) * 0.1).astype(np.float32)
    # softplus over a wide range, past torch's threshold of 20
    sp = np.concatenate([rng.standard_normal(4000) * 8,
                         np.linspace(-40, 40, 97)]).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jax.jit(jssm._gated_norm)(jnp.asarray(x, jd), jnp.asarray(z, jd),
                                     jnp.asarray(scale, jd))
    td = getattr(torch, dtype)
    got = tssm._gated_norm(_t(x).to(td), _t(z).to(td), _t(scale).to(td))
    assert got.dtype == td
    bits, ulps = (F32_BITS, 4) if dtype == "float32" else (BF16_BITS, 1)
    assert_ulps_of_scale(want, got, bits, ulps, "gated norm")
    want_sp = jax.jit(jax.nn.softplus)(sp)
    assert_ulps_of_scale(want_sp, tssm.softplus(_t(sp)), F32_BITS, 4,
                         "softplus")


# --------------------------------------------------------- the Mamba layer
def _layer_cfgs(dtype):
    changes = dict(param_dtype=dtype, compute_dtype=dtype, ssm_groups=2)
    return (dataclasses.replace(jconfigs.get_reduced("mamba2_1_3b"),
                                **changes),
            dataclasses.replace(tconfigs.get_reduced("mamba2_1_3b"),
                                **changes))


def _ref_layer_run(p, x, cfg):
    """The full sequence (out, cache), then SEQ decode steps from an empty
    cache (outs, final cache), in one program."""
    out, cache = jssm.mamba_forward(p, x, cfg)

    def step(c, xt):
        y, c = jssm.mamba_forward(p, xt[:, None], cfg, c)
        return c, y[:, 0]

    c, ys = jax.lax.scan(step, jssm.init_mamba_cache(cfg, x.shape[0],
                                                     cfg.cdtype),
                         jnp.swapaxes(x, 0, 1))
    return out, cache, jnp.swapaxes(ys, 0, 1), c


@functools.lru_cache(maxsize=None)
def _layer_case(dtype):
    """The reference's weights and outputs at ``dtype`` -> (weights as
    NumPy, input, reference outputs as float32 NumPy)."""
    jcfg, _ = _layer_cfgs(dtype)
    p = jssm.init_mamba(jax.random.PRNGKey(3), jcfg)
    for name in ("in_proj", "conv_w", "out_proj"):
        p[name] = (p[name].astype(jnp.float32) * 20).astype(jcfg.pdtype)
    x = np.random.default_rng(4).standard_normal(
        (2, SEQ, jcfg.d_model)).astype(np.float32)
    outs = jax.jit(functools.partial(_ref_layer_run, cfg=jcfg))(
        p, jnp.asarray(x, jcfg.cdtype))
    outs = jax.tree.map(lambda a: np.asarray(a, np.float32), outs)
    return jax.tree.map(np.asarray, p), x, outs


def _port_layer(dtype):
    p, x, want = _layer_case(dtype)
    _, tcfg = _layer_cfgs(dtype)
    layer = tssm.init_mamba(tcfg, None, "cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(layer, name).copy_(_t(leaf))
    return layer, tcfg, _t(x).to(tcfg.cdtype), want


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_forward_and_its_cache_are_the_references(dtype):
    layer, cfg, x, (out, cache, _, _) = _port_layer(dtype)
    bits, ulps = TOL[dtype]
    with torch.inference_mode():
        got, got_cache = tssm.mamba_forward(layer, x, cfg)
    assert got.dtype == cfg.cdtype and set(got_cache) == {"conv", "h"}
    assert got_cache["h"].dtype == cfg.cdtype
    assert_ulps_of_scale(out, got, bits, ulps, "forward")
    assert_ulps_of_scale(cache["conv"], got_cache["conv"], bits, ulps, "conv")
    assert_ulps_of_scale(cache["h"], got_cache["h"], bits, ulps, "h")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_steps_are_the_references(dtype):
    """SEQ one-token steps from an empty cache: each step's output and
    the final cache (at bf16 the state rounded to bf16 every step)."""
    layer, cfg, x, (_, _, steps, cache) = _port_layer(dtype)
    bits, ulps = TOL[dtype]
    c = tssm.init_mamba_cache(cfg, 2, cfg.cdtype, "cpu")
    ys = []
    with torch.inference_mode():
        for t in range(SEQ):
            before = {k: v.clone() for k, v in c.items()}
            y, c2 = tssm.mamba_forward(layer, x[:, t: t + 1], cfg, c)
            assert all(torch.equal(before[k], c[k]) for k in c)
            c = c2
            ys.append(y)
    assert c["h"].dtype == cfg.cdtype
    assert_ulps_of_scale(steps, torch.cat(ys, 1), bits, ulps, "steps")
    assert_ulps_of_scale(cache["conv"], c["conv"], bits, ulps, "conv")
    assert_ulps_of_scale(cache["h"], c["h"], bits, ulps, "h")


def test_init_mamba_has_the_references_leaves():
    """Names, shapes and dtypes of ``init_mamba`` at bf16 (A_log, D and
    dt_bias float32), and A_log = log(linspace(1, 16, H)) within 2 ulps
    (``torch.linspace`` and ``torch.log`` against ``jnp.linspace`` and
    XLA's ``log``: measured 1)."""
    jcfg, tcfg = _layer_cfgs("bfloat16")
    want = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    got = dict(tssm.init_mamba(tcfg, torch.Generator().manual_seed(0),
                               "cpu").named_parameters())
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert ulp_distance(got["A_log"], want["A_log"]).max() <= 2
    for name in ("in_proj", "conv_w", "out_proj"):
        sd = float(got[name].float().std())
        assert 0.015 < sd < 0.025, (name, sd)


# --------------------------------------------------- models and convert
def _model_cfgs(arch, dtype):
    changes = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_reduced(arch), **changes),
            dataclasses.replace(tconfigs.get_reduced(arch), **changes))


@functools.lru_cache(maxsize=None)
def _tree(arch, dtype):
    """The reference's weights, initialised in one program."""
    jcfg, _ = _model_cfgs(arch, dtype)
    return jax.tree.map(np.asarray, jax.jit(
        jm.init_params, static_argnums=1)(jax.random.PRNGKey(7), jcfg))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_convert_round_trip_carries_mamba(arch):
    """The reference's tree -> the port's Model -> the reference's tree,
    every leaf back bit for bit: the ``mamba`` subtrees (A_log, D and
    dt_bias float32 at bf16), jamba's attention, MoE and dense MLPs."""
    tree = _tree(arch, "bfloat16")
    _, tcfg = _model_cfgs(arch, "bfloat16")
    params = convert.lm_params_from_numpy(tcfg, tree, "cpu")
    mamba = [lay.mamba for lay in params.all_layers()
             if lay.spec.kind == "mamba"]
    assert len(mamba) == sum(s.kind == "mamba" for s in tcfg.layer_specs())
    assert mamba[0].A_log.dtype == torch.float32
    assert mamba[0].in_proj.dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(want, np.float32), got,
                                      jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cache_to_numpy_has_the_references_layout(arch):
    """A prefilled port cache in the reference's layout: the same tree of
    leaves, shapes and dtypes as the reference's ``init_cache`` (Mamba's
    conv/h beside jamba's attention k/v/len)."""
    jcfg, tcfg = _model_cfgs(arch, "float32")
    want = jax.eval_shape(lambda: jm.init_cache(jcfg, 2, 9))
    params = tm.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    with torch.inference_mode():
        _, caches, _ = tm.prefill(params, torch.zeros((2, 3), dtype=torch.int32),
                                  tcfg, 9)
    got = convert.lm_cache_to_numpy(tcfg, caches)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.shape == g.shape
        assert (g.dtype == np.int32) == (w.dtype == jnp.int32)
    assert int(got["step"]) == 3
