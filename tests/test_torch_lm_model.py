"""Port parity for the decoders: repro_torch.models.model and
repro_torch.launch.steps against repro.models.model / repro.launch.steps.

Each of the five dense reduced configs (olmo_1b, deepseek_7b,
h2o_danube_3_4b, minitron_4b, qwen2_vl_2b), minitron with padded heads
(6 heads padded to 8), deepseek-7b with a 30.0 logit softcap and GeGLU,
and the two MoE configs, grok-1 (every layer MoE, 4 experts top-2, soft
cap) and deepseek-v3 (MLA, a dense prefix layer, 8 experts top-2 and a
shared expert, the MTP head's weights carried but not run), runs in both
packages on the reference's own weights (its ``init_params``, carried
across by ``convert``) and the same seeded prompt of 20 tokens, at the
config's bfloat16 and at float32:

- ``forward`` logits and aux loss (the MoE configs' capacity drops
  pairs over the 20 tokens, as the reference's does), ``prefill`` logits
  and its caches (h2o's window of 16 makes its cache a ring buffer that
  wraps; deepseek-v3's is MLA's latent ``ckv`` / ``k_rope``);
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

A MoE router reads hidden states an ulp or so off the reference's, so a
token whose k-th and (k+1)-th router probabilities lie closer than
``ROUTER_TIE`` (2^-16 at float32, 2^-10 at bfloat16; the port's own
probabilities, recorded by ``moe.recording``) is a near-tie either side
may route its own way.  From a row's first near-tie position on, that
row's logits and caches may leave the tolerance (the test prints it, and
holds every position before it), the aux loss is not compared, and its
tokens are compared only up to the step the near-tie reaches (at
float32 a near-tie fails the test: its tokens must be equal).  None of
the cases has one at the seeds below (smallest margin 1.9e-4, deepseek-v3
at bfloat16), so every number is held.

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
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale, ulp_of_scale)

DENSE = ("olmo_1b", "deepseek_7b", "h2o_danube_3_4b", "minitron_4b",
         "qwen2_vl_2b")
# name -> (arch, changes to its reduced config)
CASES = {a: (a, {}) for a in DENSE}
CASES["minitron_4b+pad_heads"] = ("minitron_4b", dict(attn_pad_heads=8))
CASES["deepseek_7b+softcap"] = ("deepseek_7b", dict(logit_softcap=30.0,
                                                    act="gelu"))
MOE_ARCHS = ("grok_1_314b", "deepseek_v3_671b")
CASES.update({a: (a, {}) for a in MOE_ARCHS})
DTYPES = ("bfloat16", "float32")
TOL = {"float32": (F32_BITS, 16), "bfloat16": (BF16_BITS, 4)}
SEQ, STEPS = 20, 3
MAX_LEN = SEQ + STEPS + 2
# a router near-tie: the port's k-th and (k+1)-th probabilities this close
ROUTER_TIE = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -10}


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
    """forward (logits and aux), prefill and STEPS greedy serve steps (the
    reference's ``make_serve_step``: argmax of ``decode_step``'s logits,
    kept here for the margins), in one program."""
    logits, aux = jm.forward(tree, toks, cfg)
    pre, caches, _ = jm.prefill(tree, toks, cfg, MAX_LEN)
    tok = jnp.argmax(pre[:, -1:], -1).astype(jnp.int32)

    def step(carry, _):
        tok, caches = carry
        out, caches = jm.decode_step(tree, tok, caches, cfg)
        nxt = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        return (nxt, caches), (nxt[:, 0], out[:, -1])

    _, (toks, outs) = jax.lax.scan(step, (tok, caches), None, length=STEPS)
    return (logits, aux, pre, caches, jnp.concatenate([tok, toks.T], 1),
            [pre[:, -1]] + list(outs))


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """The reference's outputs, once per module and case."""
    cfg = _cfg(jconfigs, case, dtype)
    tree = _tree(case, dtype)
    toks = jnp.asarray(_prompt(cfg))
    logits, aux, pre, caches, tokens, step_logits = jax.jit(
        functools.partial(_reference_run, cfg=cfg))(tree, toks)
    cache_np = jax.tree.map(lambda x: np.asarray(x, np.float32)
                            if x.dtype != jnp.int32 else np.asarray(x), caches)
    return dict(tree=tree, toks=np.asarray(toks),
                logits=np.asarray(logits, np.float32), aux=float(aux),
                prefill=np.asarray(pre, np.float32), caches=cache_np,
                tokens=np.asarray(tokens),
                margins=[_margin(x) for x in step_logits])


def _near_ties(records, cfg, dtype, positions) -> np.ndarray:
    """The port's recorded routing -> (B, positions) bool: some MoE layer
    routed that position within ``ROUTER_TIE``.  A full-sequence run
    records one call a layer over every position; the step loop one call
    a layer and step."""
    near = np.zeros((2, positions), bool)
    for i, (probs, _) in enumerate(records):
        top = torch.topk(probs, cfg.top_k + 1, -1).values.numpy()
        tie = top[..., -2] - top[..., -1] < ROUTER_TIE[dtype]    # (B, S)
        if tie.shape[1] == positions:
            near |= tie
        else:
            near[:, i // _n_moe(cfg)] |= tie[:, 0]
    return near


def _n_moe(cfg) -> int:
    return sum(s.moe for s in cfg.layer_specs())


def _first(near) -> np.ndarray:
    """(B,) each row's first near-tie position (the length if none)."""
    return np.where(near.any(1), near.argmax(1), near.shape[1])


def _port(case, dtype, tree, toks):
    cfg = _cfg(tconfigs, case, dtype)
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    t = torch.from_numpy(np.array(toks))
    assert tsteps.make_prefill_step(cfg)(params, t).shape == (2, SEQ,
                                                              cfg.vocab)
    with tmoe.recording() as fwd_routing:
        logits, aux = tm.forward(params, t, cfg)
    with tmoe.recording() as step_routing:
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
    assert len(fwd_routing) == _n_moe(cfg)
    assert len(step_routing) == (SEQ + STEPS) * _n_moe(cfg)
    ties = dict(forward=_first(_near_ties(fwd_routing, cfg, dtype, SEQ)),
                steps=_first(_near_ties(step_routing, cfg, dtype,
                                        SEQ + STEPS)))
    return logits, aux, pre, cache_np, np.concatenate(tokens, 1), ties


def _assert_rows(want, got, bits, ulps, first, what):
    """(B, T, ...) within ``ulps`` ulps of the scale, but from each row's
    first router near-tie (``first`` (B,)) on, which is printed."""
    if (first >= want.shape[1]).all():
        assert_ulps_of_scale(want, got, bits, ulps, what)
        return
    a = np.asarray(want, np.float32)
    b = (got.float().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
    err = (np.abs(a - b).reshape(a.shape[0], a.shape[1], -1).max(-1)
           / ulp_of_scale(a, bits))
    for row, f in enumerate(first):
        assert (err[row, :f] <= ulps).all(), (what, row, err[row, :f].max())
        if f < a.shape[1]:
            print(f"{what}: row {row} held before its router near-tie at "
                  f"position {f}; after it {err[row, f:].max():.3g} ulps")


def _compare_caches(want, got, bits, ulps, first, what):
    """Every layer's cache, GQA's k/v or MLA's latent ckv/k_rope, in the
    reference's layout (prefix, then blocks stacked over periods); time
    is axis 1 of a prefix leaf, axis 2 of a stacked one."""
    assert int(want["step"]) == int(got["step"]) == SEQ
    assert len(want["prefix"]) == len(got["prefix"])
    assert len(want["blocks"]) == len(got["blocks"])
    for i, (cw, cg) in enumerate(zip(want["prefix"] + want["blocks"],
                                     got["prefix"] + got["blocks"])):
        assert set(cw["attn"]) == set(cg["attn"])
        stacked = i >= len(want["prefix"])
        for leaf in sorted(set(cw["attn"]) - {"len"}):
            w, g = cw["attn"][leaf], cg["attn"][leaf]
            if stacked:       # periods after batch: (B, P, T, ...)
                w, g = np.swapaxes(w, 0, 1), np.swapaxes(g, 0, 1)
                w, g = np.swapaxes(w, 1, 2), np.swapaxes(g, 1, 2)
            _assert_rows(w, g, bits, ulps, first,
                         f"{what} cache {i} {leaf}")
        np.testing.assert_array_equal(cw["attn"]["len"], cg["attn"]["len"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_and_greedy_tokens_are_the_reference(case, dtype):
    ref = _reference(case, dtype)
    bits, ulps = TOL[dtype]
    logits, aux, pre, caches, tokens, ties = _port(case, dtype, ref["tree"],
                                                   ref["toks"])
    assert logits.dtype == pre.dtype
    _assert_rows(ref["logits"], logits, bits, ulps, ties["forward"],
                 f"{case} forward")
    if (ties["forward"] >= SEQ).all():
        assert_ulps_of_scale(np.float32(ref["aux"]), aux, bits, ulps, "aux")
    if not _n_moe(_cfg(tconfigs, case, dtype)):
        assert float(aux) == ref["aux"] == 0.0
    _assert_rows(ref["prefill"], pre, bits, ulps, ties["steps"],
                 f"{case} prefill")
    _compare_caches(ref["caches"], caches, bits, ulps, ties["steps"], case)
    # token j comes from the logits of step SEQ - 1 + j
    limit = np.clip(ties["steps"] - (SEQ - 1), 0, STEPS + 1)
    if dtype == "bfloat16":
        tol = ulps * ulp_of_scale(ref["logits"], bits)
        for step, margin in enumerate(ref["margins"]):
            if margin < tol:
                print(f"{case} bf16: tokens compared up to step {step}: the "
                      f"reference's top-2 margin {margin:.3g} < {tol:.3g}")
                limit = np.minimum(limit, step)
                break
    for row, n in enumerate(limit):
        np.testing.assert_array_equal(ref["tokens"][row, :n],
                                      tokens[row, :n], f"row {row}")
    if dtype == "float32":
        assert (limit == STEPS + 1).all(), "a router near-tie at float32"


@pytest.mark.parametrize("case", list(CASES))
def test_port_decode_matches_its_forward(case):
    """The counterpart of tests/test_models.py::_decode_matches_forward.

    A MoE model's forward drops the pairs past each expert's capacity over
    the whole prompt, where each decode step (S = 1) drops none; its
    forward runs with capacity_factor E / K, which makes the capacity the
    sequence length, so that nothing drops there either."""
    cfg = _cfg(tconfigs, case, "float32")
    params = convert.lm_params_from_numpy(cfg, _tree(case, "float32"), "cpu")
    toks = torch.from_numpy(_prompt(cfg))
    if cfg.n_experts:
        fcfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        assert int(round(SEQ * cfg.top_k / cfg.n_experts
                         * fcfg.capacity_factor)) == SEQ
    else:
        fcfg = cfg
    full, aux = tm.forward(params, toks, fcfg)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    step, _, _ = tm.prefill(params, toks, cfg, SEQ + 1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_round_trip_carries_moe_mla_and_mtp(arch):
    """The reference's tree -> the port's Model -> the reference's tree,
    every leaf back bit for bit in its place: the MoE subtrees with the
    router float32, MLA's projections and norms, deepseek-v3's ``mtp``."""
    tree = _tree(arch, "bfloat16")
    cfg = _cfg(tconfigs, arch, "bfloat16")
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    moe_layer = params.blocks[0].moe
    assert moe_layer.router.dtype == torch.float32
    assert moe_layer.wi.dtype == torch.bfloat16
    assert (params.mtp is not None) == bool(cfg.mtp_depth)
    back = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(want, np.float32), got,
                                      jax.tree_util.keystr(path))


@pytest.mark.parametrize("key,match", [
    ("enc_in_proj", r"enc_in_proj.*18\.4 \(encoder-decoder\)"),
    ("enc_blocks", r"enc_blocks.*18\.4"),
    ("extra", r"places no \['extra'\]"),
])
def test_convert_refuses_a_key_it_does_not_place(key, match):
    """``lm_params_from_numpy`` used to read only the keys it listed and
    drop the rest silently; now a leftover subtree raises."""
    tree = dict(_tree("olmo_1b", "float32"), **{key: np.zeros((2, 2))})
    with pytest.raises(KeyError, match=match):
        convert.lm_params_from_numpy(_cfg(tconfigs, "olmo_1b", "float32"),
                                     tree, "cpu")


def test_convert_refuses_an_mtp_head_the_config_lacks():
    tree = _tree("deepseek_v3_671b", "float32")
    cfg = dataclasses.replace(_cfg(tconfigs, "deepseek_v3_671b", "float32"),
                              mtp_depth=0)
    with pytest.raises(KeyError, match=r"only in the tree \['mtp\."):
        convert.lm_params_from_numpy(cfg, tree, "cpu")
