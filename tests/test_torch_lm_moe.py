"""Port parity for the Mixture-of-Experts layer: repro_torch.models.moe
against repro.models.moe, at float32 and bfloat16.

The reference's own weights (``init_moe``, the expert matrices scaled by
20 for activations of order one, as tests/test_torch_lm_layers.py does
for the MLP) are copied into the port's ``MoE`` module and the same
seeded NumPy input goes through both; the reference's ``moe_layer`` and
its router run under one ``jax.jit`` a case.  Cases: the grok-1 and
deepseek-v3 reduced shapes (4 experts top-2 GeGLU; 8 experts top-2 with
a shared expert), a top-8 of 16 with a shared expert (eight bf16 adds a
token in the combine), a non-gated MLP, and the reference's own cases
from tests/test_models.py: the drop case (2 experts top-1,
``capacity_factor=0.25``) and the shared expert (top-1, no drops).

The routing is held first.  The router's float32 probabilities are
within 4 float32 ulps of the reference's largest (measured at most 3),
and the chosen
experts are the reference's for every token whose k-th and (k+1)-th
reference probabilities differ by more than ``TIE`` (16 float32 ulps of
1); a token closer than that is a near-tie that either side may break
its own way, and the test then prints it and compares no output.  Where
the routing agrees, ``out`` is within 16 float32 ulps of its scale at
float32 and 4 bf16 ulps at bfloat16 (measured at most 2.5 and 2: XLA
keeps some bf16 intermediates in float32 inside its fusions), and
``aux`` within 16 float32 ulps (measured 2; at bfloat16 too, since the
router runs in float32 on the same bf16 input).
The port's ``moe_layer_dense_eval`` is held against the reference's,
and against the port's own ``moe_layer`` where nothing drops (the
reference's oracle test, rtol 2e-4 / atol 2e-5 at float32).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import config as jcfg_mod  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import config as tcfg_mod  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_ulps_of_scale)

DTYPES = ("float32", "bfloat16")
OUT_ULPS = {"float32": (F32_BITS, 16), "bfloat16": (BF16_BITS, 4)}
F32_ULPS = 16           # aux, at either dtype
PROB_ULPS = 4           # router probabilities
TIE = 16 * 2.0 ** -23   # a near-tie between the k-th and (k+1)-th expert

_MOE = (jcfg_mod.LayerSpec(moe=True),)
# name -> (config fields, input shape (B, S, d))
CASES = {
    "grok_reduced": (dict(d_model=64, n_heads=4, n_kv=2, d_head=16,
                          d_ff=128, n_experts=4, top_k=2, d_ff_expert=128,
                          act="gelu"), (2, 20, 64)),
    "dsv3_reduced": (dict(d_model=64, n_heads=4, n_kv=4, d_head=16,
                          d_ff=64, n_experts=8, top_k=2, d_ff_expert=64,
                          n_shared_experts=1), (2, 20, 64)),
    "top8_shared": (dict(d_model=32, n_heads=4, n_kv=4, d_ff=32,
                         n_experts=16, top_k=8, n_shared_experts=1),
                    (2, 12, 32)),
    "mlp_relu2": (dict(d_model=32, n_heads=4, n_kv=4, d_ff=48, n_experts=4,
                       top_k=2, mlp_kind="mlp", act="relu2"), (2, 10, 32)),
    # tests/test_models.py::test_moe_capacity_drops_tokens_gracefully
    "drop": (dict(d_model=16, n_heads=2, n_kv=2, d_ff=32, n_experts=2,
                  top_k=1, capacity_factor=0.25), (2, 16, 16)),
    # tests/test_models.py::test_moe_shared_expert_always_active
    "shared": (dict(d_model=16, n_heads=2, n_kv=2, d_ff=32, n_experts=4,
                    top_k=1, n_shared_experts=1, capacity_factor=4.0),
               (1, 4, 16)),
}


def _cfgs(case, dtype, **kw):
    fields, _ = CASES[case]
    args = dict(name=case, n_layers=1, vocab=64, period=_MOE,
                param_dtype=dtype, compute_dtype=dtype, **dict(fields, **kw))
    targs = dict(args, period=(tcfg_mod.LayerSpec(moe=True),))
    return jcfg_mod.ModelConfig(**args), tcfg_mod.ModelConfig(**targs)


@functools.lru_cache(maxsize=None)
def _weights(case, dtype):
    """The reference's ``init_moe`` for the case, experts scaled by 20."""
    jc, _ = _cfgs(case, dtype)
    p = jmoe.init_moe(jax.random.PRNGKey(3), jc)
    return {k: v if k == "router" else (v * 20).astype(v.dtype)
            for k, v in p.items()}


def _port(case, dtype, cfg):
    p = tmoe.init_moe(cfg, None, "cpu")
    pj = _weights(case, dtype)
    assert sorted(n for n, _ in p.named_parameters()) == sorted(pj)
    with torch.no_grad():
        for name, leaf in pj.items():
            getattr(p, name).copy_(torch.from_numpy(np.array(leaf,
                                                             np.float32)))
    assert p.router.dtype == torch.float32
    return p


def _input(case, dtype):
    shape = CASES[case][1]
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    x = x.astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _ref_router(p, x):
    """The first lines of the reference's ``moe_layer``: its probabilities
    and its top-k experts."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, -1)
    return probs, jax.lax.top_k(probs, probs.shape[-1])[1]


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    jc, _ = _cfgs(case, dtype)
    xj, _ = _input(case, dtype)

    def run(p, x):
        out, aux = jmoe.moe_layer(p, x, jc)
        return (out, aux, jmoe.moe_layer_dense_eval(p, x, jc),
                *_ref_router(p, x))

    out, aux, dense, probs, order = jax.jit(run)(_weights(case, dtype), xj)
    return (np.asarray(out, np.float32), float(aux),
            np.asarray(dense, np.float32), np.asarray(probs),
            np.asarray(order))


def _routing_agrees(case, cfg, probs_ref, order_ref, probs, idx) -> bool:
    """The rule of the module docstring; True when every token is routed
    as the reference routes it."""
    k = cfg.top_k
    assert_ulps_of_scale(probs_ref, probs, F32_BITS, PROB_ULPS, "probs")
    ranked = np.take_along_axis(probs_ref, order_ref, -1)
    margin = ranked[..., k - 1] - ranked[..., k] if k < cfg.n_experts \
        else np.full(ranked.shape[:-1], np.inf)
    same = (np.sort(order_ref[..., :k], -1)
            == np.sort(idx.numpy(), -1)).all(-1)
    assert (same | (margin <= TIE)).all(), "routing differs off a near-tie"
    if not same.all():
        print(f"{case}: {int((~same).sum())} near-tie token(s) routed "
              "differently; outputs not compared")
    return bool(same.all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_is_the_reference(case, dtype):
    jc, tc = _cfgs(case, dtype)
    out_ref, aux_ref, dense_ref, probs_ref, order_ref = _reference(case,
                                                                   dtype)
    p = _port(case, dtype, tc)
    _, xt = _input(case, dtype)
    with tmoe.recording() as rec:
        out, aux = tmoe.moe_layer(p, xt, tc)
    (probs, idx), = rec
    assert out.dtype == xt.dtype and out.shape == xt.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    bits, ulps = OUT_ULPS[dtype]
    assert_ulps_of_scale(np.float32(aux_ref), aux.numpy(), F32_BITS,
                         F32_ULPS, "aux")
    if not _routing_agrees(case, tc, probs_ref, order_ref, probs, idx):
        return
    assert_ulps_of_scale(out_ref, out, bits, ulps, f"{case} out")
    assert_ulps_of_scale(dense_ref, tmoe.moe_layer_dense_eval(p, xt, tc),
                         bits, ulps, f"{case} dense eval")


def test_drop_case_drops_pairs_as_the_reference():
    """capacity_factor 0.25: cap 2 of 16 tokens an expert, so most pairs
    drop and their tokens get zero from the routed experts, exactly."""
    jc, tc = _cfgs("drop", "float32")
    cap = int(max(1, round(16 * 1 / 2 * 0.25)))
    assert cap == 2
    out_ref = _reference("drop", "float32")[0]
    out, _ = tmoe.moe_layer(_port("drop", "float32", tc),
                            _input("drop", "float32")[1], tc)
    zero_ref = (out_ref == 0).all(-1)
    assert zero_ref.sum() == 2 * (16 - 2 * cap)      # B x (S - E * cap)
    np.testing.assert_array_equal(zero_ref, (out.numpy() == 0).all(-1))


@pytest.mark.parametrize("case", ["grok_reduced", "dsv3_reduced",
                                  "top8_shared", "shared"])
def test_dense_oracle_is_the_sparse_dispatch_without_drops(case):
    """The reference's oracle test on the port: with capacity E/K x the
    sequence, nothing drops and ``moe_layer`` is the dense evaluation."""
    fields, _ = CASES[case]
    cf = fields["n_experts"] / fields["top_k"]
    _, tc = _cfgs(case, "float32", capacity_factor=cf)
    p = _port(case, "float32", tc)
    _, xt = _input(case, "float32")
    got, aux = tmoe.moe_layer(p, xt, tc)
    np.testing.assert_allclose(got.numpy(),
                               tmoe.moe_layer_dense_eval(p, xt, tc).numpy(),
                               rtol=2e-4, atol=2e-5)
    assert float(aux) > 0


def test_router_noise_draws_from_the_generator():
    """``router_noise`` > 0 perturbs the logits from the caller's
    generator (the same seed, the same output) and only when one is
    given, as the reference only with an rng."""
    _, tc = _cfgs("grok_reduced", "float32", router_noise=1.0)
    p = _port("grok_reduced", "float32", tc)
    _, xt = _input("grok_reduced", "float32")
    plain, _ = tmoe.moe_layer(p, xt, dataclasses.replace(tc,
                                                         router_noise=0.0))
    np.testing.assert_array_equal(tmoe.moe_layer(p, xt, tc)[0].numpy(),
                                  plain.numpy())
    a, _ = tmoe.moe_layer(p, xt, tc, torch.Generator().manual_seed(1))
    b, _ = tmoe.moe_layer(p, xt, tc, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), plain.numpy())


def test_init_draws_experts_one_at_a_time_in_the_dtypes():
    """A seeded ``init_moe``: every leaf of the reference's tree, the
    router float32 whatever the parameter dtype, N(0, 0.02) entries."""
    _, tc = _cfgs("dsv3_reduced", "bfloat16")
    p = tmoe.init_moe(tc, torch.Generator().manual_seed(0), "cpu")
    assert sorted(n for n, _ in p.named_parameters()) == sorted(
        _weights("dsv3_reduced", "bfloat16"))
    assert p.router.dtype == torch.float32
    assert p.wi.dtype == p.shared_wo.dtype == torch.bfloat16
    assert p.wi.shape == (8, 64, 64) and p.shared_wi.shape == (64, 64)
    std = p.wi.float().std().item()
    assert 0.018 < std < 0.022
    assert not torch.equal(p.wi[0], p.wi[1])
