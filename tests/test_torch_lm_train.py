"""Port parity for the training loss: repro_torch.models.model.loss_fn and
its gradients against ``jax.value_and_grad`` of repro.models.model.loss_fn.

Six reduced configs, each on the reference's own weights (its
``init_params``, carried across by ``convert``) and the same seeded
tokens and labels (two labels masked with -1): olmo (dense), grok-1 (MoE:
the aux loss), deepseek-v3 (MLA, a dense prefix layer, MoE with a shared
expert, and the MTP head's loss), mamba2 (the SSD scan's backward),
jamba (Mamba, attention and MoE, eight layers) and whisper (the encoder
and cross-attention, ``ENC_LEN`` seeded frames).  One jitted reference
program per config and dtype computes the loss, its metrics and the
gradients, shared by the file's cases.

Tolerances, in ulps of the largest magnitude (``assert_ulps_of_scale``):

- at float32 the loss, ce, aux and mtp within 16 f32 ulps of the loss
  (measured at most 1), and every gradient leaf within 64 f32 ulps of
  that leaf's largest magnitude (measured at most 15, deepseek-v3's
  ``mtp.block.mlp.wo``, and 49 for jamba's ``embed``).  jamba's Mamba
  ``A_log`` and ``dt_bias`` are held within ``JAMBA_SSM_ULPS``, 192
  (measured 87.5): their gradients are sums over every position and
  chunk that cancel down to about 3e-7, and on other seeded tokens the
  reference's own ``A_log`` gradient lay 180 ulps of that scale from the
  same gradient taken in float64, the port's 181, and the two 142 apart.
- at bfloat16 the loss within 4 bf16 ulps of itself (measured at most
  0.014).

The port's remat (a checkpoint per layer, recomputed in the backward)
gives the same loss and gradients as no remat, bit for bit, and records
each MoE layer's routing once.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import (BF16_BITS, F32_BITS,  # noqa: E402
                          assert_bitwise, assert_ulps_of_scale, ulp_of_scale)

ARCHS = ("olmo_1b", "grok_1_314b", "deepseek_v3_671b", "mamba2_1_3b",
         "jamba_1_5_large_398b", "whisper_medium")
B, SEQ, ENC_LEN = 2, 16, 12
LOSS_ULPS = {"float32": 16, "bfloat16": 4}
GRAD_ULPS = 64
JAMBA_SSM_ULPS = 192       # jamba's A_log / dt_bias (module docstring)


def _cfg(configs, arch, dtype):
    return dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype,
                               compute_dtype=dtype)


def _inputs(cfg):
    """Seeded tokens (B, SEQ), labels (the next tokens, the last two of
    row 0 masked with -1) and, for an encoder-decoder, frames."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, SEQ + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -2:] = -1
    frames = (rng.standard_normal((B, ENC_LEN, cfg.d_model))
              .astype(np.float32) if cfg.enc_dec else None)
    return toks[:, :-1], labels, frames


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's weights, inputs, loss metrics and gradients (as
    NumPy float32), from one jitted program."""
    cfg = _cfg(jconfigs, arch, dtype)
    tree = jm.init_params(jax.random.PRNGKey(5), cfg)
    tokens, labels, frames = _inputs(cfg)

    def lf(p, t, lab, f):
        return jm.loss_fn(p, t, lab, cfg, enc_frames=f)

    (_, metrics), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        tree, tokens, labels, frames)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(tree=jax.tree.map(f32, tree), tokens=tokens, labels=labels,
                frames=frames, metrics={k: f32(v) for k, v in
                                        metrics.items()},
                grads=jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(f32, grads))[0])


def _port_loss(arch, dtype, ref, remat=True):
    """The port's loss, metrics and gradients (by parameter name) on the
    reference's weights and inputs."""
    cfg = _cfg(tconfigs, arch, dtype)
    params = convert.lm_params_from_numpy(cfg, ref["tree"], "cpu")
    params.requires_grad_(True)
    f = None if ref["frames"] is None else torch.from_numpy(ref["frames"])
    loss, metrics = tm.loss_fn(params, torch.from_numpy(ref["tokens"]),
                               torch.from_numpy(ref["labels"]), cfg,
                               enc_frames=f, remat=remat)
    loss.backward()
    return params, loss, metrics, {n: p.grad for n, p in
                                   params.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_are_the_reference_f32(arch):
    ref = _reference(arch, "float32")
    params, loss, metrics, grads = _port_loss(arch, "float32", ref)
    assert set(metrics) == set(ref["metrics"])
    assert ("mtp" in metrics) == (arch == "deepseek_v3_671b")
    unit = ulp_of_scale(ref["metrics"]["loss"], F32_BITS)
    for k, v in ref["metrics"].items():
        err = abs(float(v) - metrics[k].item()) / unit
        assert err <= LOSS_ULPS["float32"], (arch, k, err)
    assert loss.item() == metrics["loss"].item()
    got = jax.tree.leaves(convert.lm_grads_to_numpy(params, grads))
    assert len(got) == len(ref["grads"])
    worst = {GRAD_ULPS: (0.0, ""), JAMBA_SSM_ULPS: (0.0, "")}
    for (path, want), g in zip(ref["grads"], got):
        name = jax.tree_util.keystr(path)
        limit = (JAMBA_SSM_ULPS if arch == "jamba_1_5_large_398b"
                 and name.endswith(("['A_log']", "['dt_bias']"))
                 else GRAD_ULPS)
        err = assert_ulps_of_scale(want, g, F32_BITS, limit,
                                   f"{arch} grad {name}")
        worst[limit] = max(worst[limit], (err, name))
    print(f"{arch} f32: loss {loss.item():.6g}; gradients within ulps of "
          f"each leaf's scale, (worst, leaf) by limit: {worst}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_is_the_reference_bf16(arch):
    ref = _reference(arch, "bfloat16")
    _, loss, metrics, grads = _port_loss(arch, "bfloat16", ref)
    err = abs(float(ref["metrics"]["loss"]) - loss.item()) / ulp_of_scale(
        ref["metrics"]["loss"], BF16_BITS)
    assert err <= LOSS_ULPS["bfloat16"], (arch, err)
    print(f"{arch} bf16: loss {err:.3g} bf16 ulps from the reference's")
    assert metrics["loss"].item() == loss.item()
    # bf16 parameters have bf16 gradients, as in the reference
    assert all(g.dtype == torch.bfloat16 for name, g in grads.items()
               if not name.endswith(("router", "A_log", "D", "dt_bias")))


@pytest.mark.parametrize("arch", ("olmo_1b", "grok_1_314b",
                                  "jamba_1_5_large_398b"))
def test_remat_is_bitwise_no_remat(arch):
    ref = _reference(arch, "float32")
    _, l_on, m_on, g_on = _port_loss(arch, "float32", ref, remat=True)
    _, l_off, m_off, g_off = _port_loss(arch, "float32", ref, remat=False)
    for k in m_on:
        assert_bitwise(m_on[k].detach(), m_off[k].detach(), k)
    assert g_on.keys() == g_off.keys()
    for name in g_on:
        assert_bitwise(g_on[name], g_off[name], name)


def test_remat_records_each_routing_once():
    """The recomputation of a checkpointed MoE layer in the backward does
    not append a second record of its routing."""
    arch = "jamba_1_5_large_398b"
    ref = _reference(arch, "float32")
    cfg = _cfg(tconfigs, arch, "float32")
    n_moe = sum(s.moe for s in cfg.layer_specs())
    for remat in (True, False):
        with tmoe.recording() as records:
            _port_loss(arch, "float32", ref, remat=remat)
        assert len(records) == n_moe, (remat, len(records))


def test_serving_leaves_gradients_off():
    """Serving's parameters carry no autograd graph; training turns it
    on, and the loss then reaches every parameter."""
    cfg = _cfg(tconfigs, "olmo_1b", "float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    logits, _ = tm.forward(params, torch.zeros((1, 4), dtype=torch.int32),
                           cfg)
    assert not logits.requires_grad
    _, _, _, grads = _port_loss("olmo_1b", "float32",
                                _reference("olmo_1b", "float32"))
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
