"""Port parity for the models: repro_torch.models.model and
repro_torch.launch.steps against repro.models.model / repro.launch.steps.

Each of the five dense reduced configs (olmo_1b, deepseek_7b,
h2o_danube_3_4b, minitron_4b, qwen2_vl_2b), minitron with padded heads
(6 heads padded to 8), deepseek-7b with a 30.0 logit softcap and GeGLU,
the two MoE configs, grok-1 (every layer MoE, 4 experts top-2, soft
cap) and deepseek-v3 (MLA, a dense prefix layer, 8 experts top-2 and a
shared expert, the MTP head's weights carried but not run), mamba2 (three
Mamba layers, no MLP, tied embeddings; SSD chunks of 8 over the 20
tokens, the last one padded), jamba (a period of [attention + dense MLP,
Mamba + MoE, Mamba + dense MLP, Mamba + MoE], twice) and whisper (two
encoder and two decoder layers with cross-attention, LayerNorm, GELU,
sinusoidal positions; ``ENC_LEN`` seeded encoder frames), runs in both
packages on the reference's own weights (its ``init_params``, carried
across by ``convert``) and the same seeded prompt of 20 tokens, at the
config's bfloat16 and at float32:

- ``forward`` logits and aux loss (the MoE configs' capacity drops
  pairs over the 20 tokens, as the reference's does), ``prefill`` logits
  and its caches (h2o's window of 16 makes its cache a ring buffer that
  wraps; deepseek-v3's is MLA's latent ``ckv`` / ``k_rope``; a Mamba
  layer's ``conv`` window and recurrent state ``h``; whisper's
  cross-attention ``xattn`` k/v) and the encoder's output;
- the first token (argmax of the prefill) and three greedy ``serve_step``
  tokens, each side feeding its own.

Tolerances, in ulps of the largest magnitude of the reference's tensor
(``torch_parity.assert_ulps_of_scale``), for a config of up to four
layers (encoder and decoder): 16 at float32 (measured at most 7; mamba2
6.25, whisper 5.5), 4 at bfloat16 (measured at most 1.875, mamba2's).
Each layer past four adds ``PER_LAYER`` of the products' rounding
differences, 4 at float32 and 2 at bfloat16: jamba's eight layers (six
of them Mamba) are held within 32 (measured 26.6) and 12 (measured 8, on
the positions before a row's router near-tie).  XLA keeps some bf16
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
rtol 2e-3, atol 2e-3).  At bfloat16 a Mamba layer's decode rounds its
recurrent state to bf16 every step and the chunked forward does not, so
the two differ by more than rounding:
``test_mamba_prefill_gap_is_the_references`` holds the port's own gap
(prefill against forward, in bf16 ulps of the forward's scale) to at
most twice the reference's own on the same weights plus one ulp
(measured: mamba2 2 against the reference's 1.88, jamba 5.75 against
5), and again at mamba2's published 48 layers with the reduced widths,
the depth of the card's check (``chip_smoke.py``'s
``LM_SSM_BF16_ULPS``; measured 12.8 against 12.5).  jamba's forward
runs at capacity_factor E / K on both sides there, where nothing drops,
as in a decode step.
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
SSM_ARCHS = ("mamba2_1_3b", "jamba_1_5_large_398b")
ENCDEC_ARCHS = ("whisper_medium",)
CASES.update({a: (a, {}) for a in SSM_ARCHS + ENCDEC_ARCHS})
DTYPES = ("bfloat16", "float32")
TOL = {"float32": (F32_BITS, 16), "bfloat16": (BF16_BITS, 4)}
# TOL holds a config of up to four layers (encoder and decoder); each layer
# past four (jamba's eight) adds up this much more of the rounding
PER_LAYER = {"float32": 4, "bfloat16": 2}
SEQ, STEPS = 20, 3
MAX_LEN = SEQ + STEPS + 2
ENC_LEN = 12           # whisper's encoder frames in these tests
# a router near-tie: the port's k-th and (k+1)-th probabilities this close
ROUTER_TIE = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -10}


def _cfg(configs, case, dtype):
    arch, changes = CASES[case]
    return dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype,
                               compute_dtype=dtype, **changes)


def _tol(cfg, dtype):
    """(mantissa bits, ulps of the scale) for ``cfg`` at ``dtype``."""
    bits, ulps = TOL[dtype]
    depth = cfg.n_layers + cfg.n_enc_layers
    return bits, ulps + PER_LAYER[dtype] * max(0, depth - 4)


def _prompt(cfg):
    return np.random.default_rng(11).integers(
        0, cfg.vocab, (2, SEQ)).astype(np.int32)


def _frames(cfg):
    """Seeded encoder frames (2, ENC_LEN, d) float32, or None."""
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(12).standard_normal(
        (2, ENC_LEN, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tree(case, dtype):
    """The reference's weights for the case, as NumPy."""
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(5), _cfg(jconfigs, case, dtype)))


def _margin(logits) -> float:
    """The smallest top-1 minus top-2 gap over the rows of (B, V)."""
    top = np.sort(np.asarray(logits, np.float32), -1)
    return float((top[:, -1] - top[:, -2]).min())


def _no_drops(cfg):
    """``cfg`` at capacity_factor E / K (nothing drops), or as it is
    without MoE."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _reference_run(tree, toks, frames, cfg):
    """forward (logits and aux; for a Mamba config at bf16 also logits
    without drops), prefill and STEPS greedy serve steps (the reference's
    ``make_serve_step``: argmax of ``decode_step``'s logits, kept here for
    the margins), in one program."""
    logits, aux = jm.forward(tree, toks, cfg, enc_frames=frames)
    mamba = any(spec.kind == "mamba" for spec in cfg.layer_specs())
    no_drops = (jm.forward(tree, toks, _no_drops(cfg))[0]
                if mamba and cfg.compute_dtype == "bfloat16" else None)
    pre, caches, enc = jm.prefill(tree, toks, cfg, MAX_LEN,
                                  enc_frames=frames)
    tok = jnp.argmax(pre[:, -1:], -1).astype(jnp.int32)

    def step(carry, _):
        tok, caches = carry
        out, caches = jm.decode_step(tree, tok, caches, cfg)
        nxt = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        return (nxt, caches), (nxt[:, 0], out[:, -1])

    _, (toks, outs) = jax.lax.scan(step, (tok, caches), None, length=STEPS)
    return (logits, aux, pre, caches, jnp.concatenate([tok, toks.T], 1),
            [pre[:, -1]] + list(outs), enc, no_drops)


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """The reference's outputs, once per module and case."""
    cfg = _cfg(jconfigs, case, dtype)
    tree = _tree(case, dtype)
    toks = jnp.asarray(_prompt(cfg))
    frames = _frames(cfg)
    logits, aux, pre, caches, tokens, step_logits, enc, no_drops = jax.jit(
        functools.partial(_reference_run, cfg=cfg))(tree, toks, frames)
    cache_np = jax.tree.map(lambda x: np.asarray(x, np.float32)
                            if x.dtype != jnp.int32 else np.asarray(x), caches)
    return dict(tree=tree, toks=np.asarray(toks),
                logits=np.asarray(logits, np.float32), aux=float(aux),
                prefill=np.asarray(pre, np.float32), caches=cache_np,
                tokens=np.asarray(tokens), frames=frames,
                enc=None if enc is None else np.asarray(enc, np.float32),
                no_drops=(None if no_drops is None
                          else np.asarray(no_drops, np.float32)),
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


def _port(case, dtype, tree, toks, frames):
    cfg = _cfg(tconfigs, case, dtype)
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    t = torch.from_numpy(np.array(toks))
    f = None if frames is None else torch.from_numpy(frames)
    assert tsteps.make_prefill_step(cfg)(params, t, f).shape == (
        2, SEQ, cfg.vocab)
    with tmoe.recording() as fwd_routing:
        logits, aux = tm.forward(params, t, cfg, enc_frames=f)
    with tmoe.recording() as step_routing:
        pre, caches, enc = tm.prefill(params, t, cfg, MAX_LEN,
                                      enc_frames=f)
        assert (enc is None) == (f is None)
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
    return (logits, aux, pre, cache_np, np.concatenate(tokens, 1), ties,
            enc)


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
    """Every layer's cache in the reference's layout (prefix, then blocks
    stacked over periods): "attn" (GQA's k/v or MLA's latent ckv/k_rope;
    time is axis 1 of a prefix leaf, axis 2 of a stacked one, held up to
    each row's first router near-tie), "mamba" (conv, h: a row's state
    sums every position, so it is held only in rows with no near-tie)
    and "xattn" (k, v of the encoder's output)."""
    assert int(want["step"]) == int(got["step"]) == SEQ
    assert len(want["prefix"]) == len(got["prefix"])
    assert len(want["blocks"]) == len(got["blocks"])
    clean = first >= SEQ
    for i, (cw, cg) in enumerate(zip(want["prefix"] + want["blocks"],
                                     got["prefix"] + got["blocks"])):
        assert set(cw) == set(cg), (i, set(cw), set(cg))
        stacked = i >= len(want["prefix"])
        for part in sorted(cw):
            assert set(cw[part]) == set(cg[part])
            for leaf in sorted(set(cw[part]) - {"len"}):
                w, g = cw[part][leaf], cg[part][leaf]
                assert w.shape == g.shape, (i, part, leaf)
                if stacked:       # periods after batch: (B, P, ...)
                    w, g = np.swapaxes(w, 0, 1), np.swapaxes(g, 0, 1)
                name = f"{what} cache {i} {part}.{leaf}"
                if part == "attn":
                    if stacked:   # time after batch: (B, T, P, ...)
                        w, g = np.swapaxes(w, 1, 2), np.swapaxes(g, 1, 2)
                    _assert_rows(w, g, bits, ulps, first, name)
                elif clean.any():
                    assert_ulps_of_scale(w[clean], g[clean], bits, ulps,
                                         name)
            if "len" in cw[part]:
                np.testing.assert_array_equal(cw[part]["len"],
                                              cg[part]["len"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_and_greedy_tokens_are_the_reference(case, dtype):
    ref = _reference(case, dtype)
    bits, ulps = _tol(_cfg(tconfigs, case, dtype), dtype)
    logits, aux, pre, caches, tokens, ties, enc = _port(
        case, dtype, ref["tree"], ref["toks"], ref["frames"])
    assert logits.dtype == pre.dtype
    if ref["enc"] is not None:
        assert_ulps_of_scale(ref["enc"], enc, bits, ulps, f"{case} encoder")
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
    fcfg = _no_drops(cfg)
    if cfg.n_experts:
        assert int(round(SEQ * cfg.top_k / cfg.n_experts
                         * fcfg.capacity_factor)) == SEQ
    frames = _frames(cfg)
    f = None if frames is None else torch.from_numpy(frames)
    full, aux = tm.forward(params, toks, fcfg, enc_frames=f)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    step, _, _ = tm.prefill(params, toks, cfg, SEQ + 1, enc_frames=f)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def _bf16_gap(full, step, scale) -> float:
    """max |full - step| in bf16 ulps of ``scale``'s largest magnitude."""
    err = np.abs(np.asarray(full, np.float32) - np.asarray(step, np.float32))
    return float(err.max()) / ulp_of_scale(scale, BF16_BITS)


def _deep_reference(arch, n_layers):
    """The reference's tree, prompt, forward and step-loop prefill at bf16
    with ``n_layers`` layers of the reduced config's widths."""
    cfg = dataclasses.replace(_cfg(jconfigs, arch, "bfloat16"),
                              n_layers=n_layers)
    tree = jax.tree.map(np.asarray,
                        jm.init_params(jax.random.PRNGKey(5), cfg))
    toks = _prompt(cfg)
    full, pre = jax.jit(lambda p, t: (
        jm.forward(p, t, cfg)[0], jm.prefill(p, t, cfg, SEQ + 1)[0]))(
            tree, toks)
    return dict(tree=tree, toks=toks, prefill=np.asarray(pre, np.float32),
                no_drops=np.asarray(full, np.float32))


# the configs' own depth, and mamba2's published 48 layers at the reduced
# widths: the depth the card's prefill-vs-forward check runs at
GAP_CASES = {"mamba2_1_3b": ("mamba2_1_3b", None),
             "jamba_1_5_large_398b": ("jamba_1_5_large_398b", None),
             "mamba2_1_3b+48_layers": ("mamba2_1_3b", 48)}


@pytest.mark.parametrize("case", list(GAP_CASES))
def test_mamba_prefill_gap_is_the_references(case):
    arch, n_layers = GAP_CASES[case]
    ref = (_reference(arch, "bfloat16") if n_layers is None
           else _deep_reference(arch, n_layers))
    ref_gap = _bf16_gap(ref["no_drops"], ref["prefill"], ref["no_drops"])
    cfg = _cfg(tconfigs, arch, "bfloat16")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = convert.lm_params_from_numpy(cfg, ref["tree"], "cpu")
    t = torch.from_numpy(np.array(ref["toks"]))
    with torch.inference_mode():
        full, _ = tm.forward(params, t, _no_drops(cfg))
        step, _, _ = tm.prefill(params, t, cfg, SEQ + 1)
    gap = _bf16_gap(full.float(), step.float(), ref["no_drops"])
    print(f"{case} bf16 prefill vs forward: port {gap:.3g}, reference "
          f"{ref_gap:.3g} bf16 ulps of the scale")
    assert gap <= 2 * ref_gap + 1, (gap, ref_gap)


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
    ("enc_in_proj", r"places no \['enc_in_proj'\].*has no encoder"),
    ("enc_blocks", r"places no \['enc_blocks'\].*has no encoder"),
    ("extra", r"places no \['extra'\]"),
])
def test_convert_refuses_a_key_it_does_not_place(key, match):
    """``lm_params_from_numpy`` used to read only the keys it listed and
    drop the rest silently; now a leftover subtree raises (olmo_1b is a
    decoder: it has no encoder to place ``enc_*`` keys in)."""
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
