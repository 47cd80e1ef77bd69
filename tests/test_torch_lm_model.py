"""Port parity for the dense decoders: repro_torch.models.model and
repro_torch.launch.steps against repro.models.model / repro.launch.steps.

Each of the five dense reduced configs (olmo_1b, deepseek_7b,
h2o_danube_3_4b, minitron_4b, qwen2_vl_2b), minitron with padded heads
(6 heads padded to 8) and deepseek-7b with a 30.0 logit softcap and GeGLU
runs in both packages on the reference's own weights (its ``init_params``,
carried across by ``convert``) and the same seeded prompt of 20 tokens,
at the config's bfloat16 and at float32:

- ``make_prefill_step`` (the full-sequence ``forward``) logits,
  ``prefill`` logits and its caches (h2o's window of 16 makes its cache a
  ring buffer that wraps);
- the first token (argmax of the prefill) and three greedy ``serve_step``
  tokens, each side feeding its own.

Tolerances, in ulps of the largest magnitude of the reference's tensor
(``torch_parity.assert_ulps_of_scale``): 16 at float32 (measured at most
7), 4 at bfloat16 (measured at most 1.125).  XLA keeps some bf16
intermediates in float32 inside its fusions and sums in its own order,
so the port is ulp-close, not bitwise.  At float32 the tokens are equal.
At bfloat16 they are equal up to the first step where a row's top-2
margin in the reference's logits is under the logit tolerance; from that
step on a tie may break either way, and the test prints the step.

The port's own step-loop prefill is also held against its forward, at
float32 with the reference test's tolerance (tests/test_models.py:
rtol 2e-3, atol 2e-3).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale, ulp_of_scale)

DENSE = ("olmo_1b", "deepseek_7b", "h2o_danube_3_4b", "minitron_4b",
         "qwen2_vl_2b")
# name -> (arch, changes to its reduced config)
CASES = {a: (a, {}) for a in DENSE}
CASES["minitron_4b+pad_heads"] = ("minitron_4b", dict(attn_pad_heads=8))
CASES["deepseek_7b+softcap"] = ("deepseek_7b", dict(logit_softcap=30.0,
                                                    act="gelu"))
DTYPES = ("bfloat16", "float32")
TOL = {"float32": (F32_BITS, 16), "bfloat16": (BF16_BITS, 4)}
SEQ, STEPS = 20, 3
MAX_LEN = SEQ + STEPS + 2


def _cfg(configs, case, dtype):
    arch, changes = CASES[case]
    return dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype,
                               compute_dtype=dtype, **changes)


def _prompt(cfg):
    return np.random.default_rng(11).integers(
        0, cfg.vocab, (2, SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tree(case, dtype):
    """The reference's weights for the case, as NumPy."""
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(5), _cfg(jconfigs, case, dtype)))


def _margin(logits) -> float:
    """The smallest top-1 minus top-2 gap over the rows of (B, V)."""
    top = np.sort(np.asarray(logits, np.float32), -1)
    return float((top[:, -1] - top[:, -2]).min())


def _reference_run(tree, toks, cfg):
    """forward, prefill and STEPS greedy serve steps (the reference's
    ``make_serve_step``: argmax of ``decode_step``'s logits, kept here for
    the margins), in one program."""
    logits = jsteps.make_prefill_step(cfg)(tree, toks)
    pre, caches, _ = jm.prefill(tree, toks, cfg, MAX_LEN)
    tok = jnp.argmax(pre[:, -1:], -1).astype(jnp.int32)

    def step(carry, _):
        tok, caches = carry
        out, caches = jm.decode_step(tree, tok, caches, cfg)
        nxt = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        return (nxt, caches), (nxt[:, 0], out[:, -1])

    _, (toks, outs) = jax.lax.scan(step, (tok, caches), None, length=STEPS)
    return (logits, pre, caches, jnp.concatenate([tok, toks.T], 1),
            [pre[:, -1]] + list(outs))


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """The reference's outputs, once per module and case."""
    cfg = _cfg(jconfigs, case, dtype)
    tree = _tree(case, dtype)
    toks = jnp.asarray(_prompt(cfg))
    logits, pre, caches, tokens, step_logits = jax.jit(
        functools.partial(_reference_run, cfg=cfg))(tree, toks)
    cache_np = jax.tree.map(lambda x: np.asarray(x, np.float32)
                            if x.dtype != jnp.int32 else np.asarray(x), caches)
    return dict(tree=tree, toks=np.asarray(toks),
                logits=np.asarray(logits, np.float32),
                prefill=np.asarray(pre, np.float32), caches=cache_np,
                tokens=np.asarray(tokens),
                margins=[_margin(x) for x in step_logits])


def _port(case, dtype, tree, toks):
    cfg = _cfg(tconfigs, case, dtype)
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    t = torch.from_numpy(np.array(toks))
    logits = tsteps.make_prefill_step(cfg)(params, t)
    pre, caches, enc = tm.prefill(params, t, cfg, MAX_LEN)
    assert enc is None
    cache_np = convert.lm_cache_to_numpy(cfg, caches)
    serve_step = tsteps.make_serve_step(cfg)
    tok = torch.argmax(pre[:, -1:], -1).to(torch.int32)
    tokens = [tok.numpy()]
    for _ in range(STEPS):
        tok, caches = serve_step(params, tok, caches)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        tokens.append(tok.numpy())
    return logits, pre, cache_np, np.concatenate(tokens, 1)


def _compare_caches(want, got, bits, ulps, what):
    assert int(want["step"]) == int(got["step"]) == SEQ
    assert len(want["prefix"]) == len(got["prefix"]) == 0
    for i, (cw, cg) in enumerate(zip(want["blocks"], got["blocks"])):
        for leaf in ("k", "v"):
            assert_ulps_of_scale(cw["attn"][leaf], cg["attn"][leaf], bits,
                                 ulps, f"{what} cache {i} {leaf}")
        np.testing.assert_array_equal(cw["attn"]["len"], cg["attn"]["len"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_and_greedy_tokens_are_the_reference(case, dtype):
    ref = _reference(case, dtype)
    bits, ulps = TOL[dtype]
    logits, pre, caches, tokens = _port(case, dtype, ref["tree"], ref["toks"])
    assert logits.dtype == pre.dtype
    assert_ulps_of_scale(ref["logits"], logits, bits, ulps, "forward")
    assert_ulps_of_scale(ref["prefill"], pre, bits, ulps, "prefill")
    _compare_caches(ref["caches"], caches, bits, ulps, case)
    if dtype == "float32":
        np.testing.assert_array_equal(ref["tokens"], tokens)
        return
    tol = ulps * ulp_of_scale(ref["logits"], bits)
    for step, margin in enumerate(ref["margins"]):
        if margin < tol:
            print(f"{case} bf16: tokens compared up to step {step}: the "
                  f"reference's top-2 margin {margin:.3g} < {tol:.3g}")
            break
        np.testing.assert_array_equal(ref["tokens"][:, step],
                                      tokens[:, step], f"step {step}")


@pytest.mark.parametrize("case", list(CASES))
def test_port_decode_matches_its_forward(case):
    """The counterpart of tests/test_models.py::_decode_matches_forward."""
    cfg = _cfg(tconfigs, case, "float32")
    params = convert.lm_params_from_numpy(cfg, _tree(case, "float32"), "cpu")
    toks = torch.from_numpy(_prompt(cfg))
    full, aux = tm.forward(params, toks, cfg)
    assert float(aux) == 0.0
    step, _, _ = tm.prefill(params, toks, cfg, SEQ + 1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
