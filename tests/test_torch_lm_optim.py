"""Port parity for the optimizer, the data pipeline and the partition rules:
repro_torch.optim.adamw, repro_torch.data and repro_torch.models.sharding
against repro.optim.adamw, repro.data and repro.models.sharding.

AdamW runs on seeded trees: the reduced jamba (norm scales and Mamba's
``A_log``/``D``/``dt_bias``/``conv_b``/``norm_scale`` inside the stacked
``blocks``), deepseek-v3 (the same vectors in ``prefix`` and ``mtp``,
unstacked) and whisper (the stacked encoder) at float32, with seeded
gradients and moments at step 3 of a schedule that warms up for 2 steps.
The reference's update runs jitted, as its train step runs it.

- The clip inactive (clip_norm 1e3): parameters, moments and the step
  bitwise, the learning rate bitwise, the global norm within 8 f32 ulps
  (PyTorch sums a leaf's squares in its own order; measured at most 6).
- The clip active (clip_norm 1.0): given the reference's global norm the
  update is bitwise; with its own, the port's clip scale may sit an ulp
  off, and the parameters and moments are held within ``CLIP_ULPS`` f32
  ulps of each leaf's scale (measured at most 4).
- The decay follows the reference leaf's rank: a vector inside the
  stacked ``blocks`` or ``enc_blocks`` decays, the same vector in
  ``prefix``, ``mtp`` or ``final_norm`` does not.
- ``cosine_lr`` bitwise over warm-up and cosine steps (XLA multiplies by
  the reciprocal of a constant divisor; its float32 cos is correctly
  rounded).

``SyntheticLMData`` batches are bitwise the reference's, a restored
cursor included, and so is ``tsp_batch_stream``.  ``param_specs`` and
``data_specs`` equal the reference's on an abstract (2, 4) mesh of
("data", "model") for every architecture, reduced and published (the
port's parameters on the meta device: shapes only), the period axis of a
stacked leaf dropped.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from torch_parity import (F32_BITS, assert_bitwise,  # noqa: E402
                          assert_ulps_of_scale, ulp_distance)

TREE_ARCHS = ("jamba_1_5_large_398b", "deepseek_v3_671b", "whisper_medium")
CLIPS = {"inactive": 1e3, "active": 1.0}
STEP = 3
NORM_ULPS = 8
CLIP_ULPS = 8


def _cfg(configs, arch):
    return dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _opt_cfg(clip):
    return dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)


@functools.lru_cache(maxsize=None)
def _reference(arch, clip):
    """Seeded parameters, gradients and moments, and the reference's
    jitted update of them (NumPy)."""
    tree = jm.init_params(jax.random.PRNGKey(1), _cfg(jconfigs, arch))
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(2)

    def seeded(scale, draw):
        return jax.tree.unflatten(treedef, [
            (draw(x.shape) * scale).astype(np.float32) for x in leaves])

    grads = seeded(0.01, rng.standard_normal)
    mu = seeded(0.01, rng.standard_normal)
    nu = seeded(1e-4, rng.random)
    state = ja.AdamWState(mu, nu, jnp.asarray(STEP, jnp.int32))
    cfg = ja.AdamWConfig(**_opt_cfg(clip))
    new_p, new_s, metrics = jax.jit(
        lambda g, s, p: ja.adamw_update(cfg, g, s, p))(grads, state, tree)
    host = functools.partial(jax.tree.map, np.asarray)
    return dict(tree=host(tree), grads=host(grads), mu=host(mu), nu=host(nu),
                new_p=host(new_p), new_mu=host(new_s.mu),
                new_nu=host(new_s.nu), step=int(new_s.step),
                grad_norm=np.asarray(metrics["grad_norm"]),
                lr=np.asarray(metrics["lr"]))


def _port_update(arch, ref, clip, monkeypatch=None):
    cfg = _cfg(tconfigs, arch)
    params = convert.lm_params_from_numpy(cfg, ref["tree"], "cpu")
    state = convert.lm_opt_state_from_numpy(params, ref["mu"], ref["nu"],
                                            STEP)
    grads = {name: torch.tensor(np.asarray(leaf)) for name, leaf in
             convert._port_names(cfg, ref["grads"]).items()}
    if monkeypatch is not None:        # the reference's global norm
        monkeypatch.setattr(ta, "global_norm", lambda g, p: torch.tensor(
            ref["grad_norm"]))
    params, state, metrics = ta.adamw_update(
        ta.AdamWConfig(**_opt_cfg(clip)), grads, state, params)
    return convert.lm_params_to_numpy(params), convert.lm_opt_state_to_numpy(
        params, state), metrics


def _keystr(path: tuple) -> str:
    """A ``reference_leaves`` path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


def _leaves_bitwise(want, got, what):
    w, g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(w) == len(g), what
    for a, b in zip(w, g):
        assert_bitwise(a, b, what)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_adamw_update_is_the_references(arch, clip, monkeypatch):
    ref = _reference(arch, CLIPS[clip])
    params, opt, metrics = _port_update(arch, ref, CLIPS[clip])
    norm_err = int(ulp_distance(ref["grad_norm"], metrics["grad_norm"]))
    assert norm_err <= NORM_ULPS, norm_err
    assert_bitwise(ref["lr"], metrics["lr"], "lr")
    assert int(opt["step"]) == ref["step"] == STEP + 1
    if clip == "inactive":
        assert float(ref["grad_norm"]) < CLIPS[clip]
        _leaves_bitwise(ref["new_p"], params, "params")
        _leaves_bitwise(ref["new_mu"], opt["mu"], "mu")
        _leaves_bitwise(ref["new_nu"], opt["nu"], "nu")
        return
    assert float(ref["grad_norm"]) > CLIPS[clip]
    worst = 0.0
    for key, got in (("new_p", params), ("new_mu", opt["mu"]),
                     ("new_nu", opt["nu"])):
        for a, b in zip(jax.tree.leaves(ref[key]), jax.tree.leaves(got)):
            worst = max(worst, assert_ulps_of_scale(a, b, F32_BITS,
                                                    CLIP_ULPS, key))
    print(f"{arch} clipped: global norm {norm_err} ulps off, the update "
          f"within {worst:.3g} ulps of each leaf's scale")
    params, opt, _ = _port_update(arch, ref, CLIPS[clip], monkeypatch)
    _leaves_bitwise(ref["new_p"], params, "params (reference norm)")
    _leaves_bitwise(ref["new_mu"], opt["mu"], "mu (reference norm)")
    _leaves_bitwise(ref["new_nu"], opt["nu"], "nu (reference norm)")


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_decay_and_leaf_order_follow_the_reference_tree(arch):
    """``reference_leaves`` lists the reference's leaves in its order, and
    a parameter decays exactly when its reference leaf has rank >= 2."""
    ref = _reference(arch, CLIPS["inactive"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref["tree"])[0]]
    ranks = [x.ndim for x in jax.tree.leaves(ref["tree"])]
    params = tm.Model(_cfg(tconfigs, arch), None, torch.device("meta"))
    leaves = ta.reference_leaves(params)
    assert [_keystr(path) for path, _, _ in leaves] == paths
    decays = ta.decays(params)
    assert set(decays) == {n for n, _ in params.named_parameters()}
    for (_, _, names), rank in zip(leaves, ranks):
        for name in names:
            assert decays[name] == (rank >= 2), name
    one_d = {n for n, p in params.named_parameters() if p.dim() == 1}
    stacked_1d = {n for n in one_d if n.startswith(("blocks.",
                                                    "enc_blocks."))}
    assert all(decays[n] for n in stacked_1d)
    assert not any(decays[n] for n in one_d - stacked_1d)
    named = {
        "jamba_1_5_large_398b": {"blocks.1.mamba.A_log": True,
                                 "blocks.1.mamba.norm_scale": True,
                                 "blocks.0.ln1.scale": True,
                                 "final_norm.scale": False},
        "deepseek_v3_671b": {"prefix.0.attn.kv_norm": False,
                             "blocks.0.attn.kv_norm": True,
                             "mtp.norm.scale": False,
                             "mtp.proj": True},
        "whisper_medium": {"enc_blocks.0.ln1.bias": True,
                           "enc_final_norm.scale": False},
    }[arch]
    assert {n: decays[n] for n in named} == named


def test_cosine_lr_is_the_references_bitwise():
    for warm, total in ((7, 100), (100, 10000), (1, 2)):
        cfg = ja.AdamWConfig(lr=3e-3, warmup_steps=warm, total_steps=total)
        steps = np.unique(np.r_[0:130, total - 3:total + 3]).astype(np.int32)
        want = np.asarray(jax.jit(jax.vmap(
            lambda s: ja.cosine_lr(cfg, s)))(steps))
        tcfg = ta.AdamWConfig(lr=3e-3, warmup_steps=warm, total_steps=total)
        got = np.array([ta.cosine_lr(tcfg, torch.tensor(int(s),
                                                        dtype=torch.int32))
                        .item() for s in steps], np.float32)
        assert_bitwise(want, got, f"lr warm {warm} total {total}")


def test_opt_state_and_grads_cross_in_the_reference_layout():
    arch = "jamba_1_5_large_398b"
    ref = _reference(arch, CLIPS["inactive"])
    params = convert.lm_params_from_numpy(_cfg(tconfigs, arch), ref["tree"],
                                          "cpu")
    state = convert.lm_opt_state_from_numpy(params, ref["mu"], ref["nu"],
                                            STEP)
    assert state.step.dtype == torch.int32 and int(state.step) == STEP
    assert all(m.dtype == torch.float32 for m in state.mu.values())
    back = convert.lm_opt_state_to_numpy(params, state)
    _leaves_bitwise(ref["mu"], back["mu"], "mu")
    _leaves_bitwise(ref["nu"], back["nu"], "nu")
    assert jax.tree.structure(back["mu"]) == jax.tree.structure(ref["mu"])
    grads = {n: torch.tensor(v) for n, v in
             convert._port_names(params.cfg, ref["grads"]).items()}
    _leaves_bitwise(ref["grads"], convert.lm_grads_to_numpy(params, grads),
                    "grads")
    init = ta.adamw_init(params)
    assert int(init.step) == 0 and init.step.dtype == torch.int32
    assert all((m == 0).all() and m.dtype == torch.float32
               for m in itertools.chain(init.mu.values(), init.nu.values()))


def test_synthetic_batches_are_the_references_bitwise():
    for vocab, seq, batch, seed in ((256, 64, 4, 0), (50304, 128, 8, 3)):
        jcfg = jdata.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                                seed=seed)
        tcfg = tdata.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                                seed=seed)
        want, got = jdata.SyntheticLMData(jcfg), tdata.SyntheticLMData(tcfg)
        for _ in range(3):
            for a, b in zip(next(want), next(got)):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
        assert got.state() == want.state() == {"step": 3, "seed": seed}
        resumed = tdata.SyntheticLMData.restore(tcfg, got.state())
        for _ in range(2):
            for a, b in zip(next(want), next(resumed)):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(AssertionError, match="seed mismatch"):
            tdata.SyntheticLMData.restore(tcfg, {"step": 0,
                                                 "seed": seed + 1})


def test_tsp_batch_stream_is_the_references_bitwise():
    for want, got in zip(itertools.islice(jdata.tsp_batch_stream(12, 3, 4),
                                          3),
                         itertools.islice(tdata.tsp_batch_stream(12, 3, 4),
                                          3)):
        np.testing.assert_array_equal(want, got)


def _spec(spec) -> tuple:
    """A PartitionSpec as a tuple (an entry of several axes a tuple)."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_param_and_data_specs_are_the_references(arch):
    amesh = AbstractMesh((2, 4), ("data", "model"))
    cpu = np.empty(8, dtype=object)
    cpu[:] = [torch.device("cpu")] * 8
    mesh = Mesh(cpu.reshape(2, 4), ("data", "model"))
    for full in (False, True):
        jcfg = jconfigs.get(arch) if full else jconfigs.get_reduced(arch)
        tcfg = tconfigs.get(arch) if full else tconfigs.get_reduced(arch)
        shapes = jax.eval_shape(lambda: jm.init_params(
            jax.random.PRNGKey(0), jcfg))
        want = jax.tree_util.tree_flatten_with_path(
            jsh.param_specs(shapes, jcfg, amesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        want = {jax.tree_util.keystr(p): _spec(s) for p, s in want}
        params = tm.Model(tcfg, None, torch.device("meta"))
        got = tsh.param_specs(params, tcfg, mesh)
        assert set(got) == {n for n, _ in params.named_parameters()}
        for path, stack, names in ta.reference_leaves(params):
            spec = want[_keystr(path)]
            for name in names:
                rank = params.get_parameter(name).dim()
                # the period axis dropped
                unstacked = (spec[1:] if stack and len(spec) == rank + 1
                             else spec)
                assert got[name] == unstacked, (full, name, got[name], spec)
        for batch in (8, 6, 3):
            assert tsh.data_specs(tcfg, mesh, batch) == _spec(
                jsh.data_specs(jcfg, amesh, batch)), batch
    one = Mesh(np.array([[torch.device("cpu")]], dtype=object),
               ("data", "model"))
    small = tm.Model(tconfigs.get_reduced(arch), None, torch.device("meta"))
    placed = tsh.to_shardings(tsh.param_specs(small, small.cfg, one), one)
    assert {d for s in placed.values() for d in s.mesh.device_list()} == \
        {torch.device("cpu")}
