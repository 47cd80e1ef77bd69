"""Port parity for the sharded train step: repro_torch.launch.steps.
make_train_step over a mesh against the reference's jitted
repro.launch.steps.make_train_step under ``NamedSharding``s, and against
the port's own one-position step; the shards, the global reductions and
the trainer over a mesh of CPU positions.

The reference runs once, in a subprocess with eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on meshes built
with ``jax.make_mesh(..., axis_types=(AxisType.Auto,) * n)``: under jax
0.9.0 ``make_mesh`` makes Explicit axes, on which the reference's own
``train()`` fails at the embedding gather.  Its step is jitted with
``in_shardings=(psh, osh, dsh, dsh[, frames])`` inside
``activation_sharding``, as its trainer and dry run do.  Every case is
float32 at batch 4, seq 32, two steps of lr 3e-3 (one warm-up step) from
the reference's ``init_params(PRNGKey(0))``, on the reference's synthetic
batches (whisper on ``ENC_LEN`` seeded frames): olmo, deepseek-v3 (MLA,
a dense prefix layer, MoE with a shared expert, MTP), jamba (Mamba,
attention and MoE) and whisper (the encoder) on a (2, 2) mesh; olmo on a
(2, 2, 2) pod mesh (the batch over pod and data); olmo with the ``fsdp``
strategy (weights over both axes, the batch over both).

Held against the reference's sharded step, the train step's limits
(tests/test_torch_lm_trainer.py): after each step the loss and its parts
within 16 f32 ulps of the loss (measured at most 2, and 15 for jamba's
eight layers), the aux within 16 ulps of itself (measured 5, jamba), the
global norm within 64 ulps (measured 30, jamba; 1 for the others), the
learning rate bitwise; after the two steps the parameters within 0.1 lr
(measured at most 0.00701); each step also from the reference's own
state before it: the parameters within 0.1 lr, the first moments within
64 f32 ulps of each leaf's scale, the second 128 (measured 40 / 62 for
jamba, at most 14 / 17 for the others), the step count equal.  jamba's
Mamba ``A_log`` and ``dt_bias`` moments are held at 192 / 384
(``SSM_ULPS``, tests/test_torch_lm_train.py's gradient limit for them),
and its parameters within 0.5 lr (``JAMBA_PARAM_LR``; measured 0.204,
``blocks[1].mamba.in_proj``): Adam's first step moves an element by
about lr x g / (|g| + eps), so an element whose gradient is within its
leaf's rounding (64 ulps of the leaf's scale) of zero moves by a
fraction of lr that the rounding decides.  The port's one-position step
lies as far from the reference there (0.203 lr), so the sharding adds
nothing to it.  The measured worst cases are printed.

Held against the port's own one-position step from the same weights: the
loss parts within 2 f32 ulps of the loss, the global norm within 2 ulps.
The parameters are held within ``OWN_PARAM_LR`` x lr, 0.05 (measured at
most 0.0101, jamba; the reference's own sharded-vs-unsharded gap for
olmo at these settings is 0.0159 lr, measured in the subprocess and
printed beside), not the reference probe's 1e-7 absolute: that probe ran
AdamW's default schedule, whose first step's learning rate is 3e-6, and
Adam turns a near-zero gradient's rounding into an update of order lr,
so the same gap at lr 3e-3 is a thousand times larger in absolute terms.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig, SyntheticLMData  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import tuning  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.models.sharded import ShardedModel  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from torch_parity import F32_BITS, assert_bitwise, ulp_of_scale  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
# name -> (arch, mesh shape, strategy)
CASES = {"olmo": ("olmo_1b", (2, 2), "2d"),
         "deepseek_v3": ("deepseek_v3_671b", (2, 2), "2d"),
         "jamba": ("jamba_1_5_large_398b", (2, 2), "2d"),
         "whisper": ("whisper_medium", (2, 2), "2d"),
         "olmo_pod": ("olmo_1b", (2, 2, 2), "2d"),
         "olmo_fsdp": ("olmo_1b", (2, 2), "fsdp")}
STEPS, BATCH, SEQ, ENC_LEN = 2, 4, 32, 12
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)
LOSS_ULPS, AUX_ULPS, NORM_ULPS = 16, 16, 64
PARAM_LR, MU_ULPS, NU_ULPS = 0.1, 64, 128
# jamba's parameters after a step (module docstring)
JAMBA_PARAM_LR = 0.5
OWN_LOSS_ULPS, OWN_NORM_ULPS, OWN_PARAM_LR = 2, 2, 0.05
SHARD_BF16_MOVED = 0.01
# jamba's Mamba A_log and dt_bias gradients cancel to ~3e-7 of their terms
# (tests/test_torch_lm_train.py's JAMBA_SSM_ULPS): their moments are held
# at 192 / 384 ulps of each leaf's scale, the others' at 64 / 128
SSM_ULPS = 192

_REFERENCE = """
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs
from repro.data import DataConfig, SyntheticLMData
from repro.launch import steps as st
from repro.models import model as jm, sharding as sh
from repro.optim import adamw as ja
CASES, STEPS, BATCH, SEQ, ENC_LEN, OPT = eval(sys.argv[2])
assert len(jax.devices()) == 8
out = {}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)


WEIGHTS = np.load(sys.argv[3])


def run(name, arch, shape, strategy, dtype, sharded=True):
    cfg = dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params = jax.tree.unflatten(treedef, [jnp.asarray(
        WEIGHTS[f"{arch}:{dtype}" + jax.tree_util.keystr(p)], x.dtype)
        for p, x in leaves])
    opt = ja.adamw_init(params)
    step = st.make_train_step(cfg, ja.AdamWConfig(**OPT), remat=True)
    frames = (np.random.default_rng(11).standard_normal(
        (BATCH, ENC_LEN, cfg.d_model)).astype(np.float32)
        if cfg.enc_dec else None)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    if sharded:
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,)
                             * len(shape),
                             devices=jax.devices()[:int(np.prod(shape))])
        if strategy == "fsdp":
            pspecs = sh.param_specs(params, cfg, mesh, fsdp_axis=axes,
                                    model_axis=None)
            keep, rem = [], BATCH
            for a in axes:
                if rem % mesh.shape[a] == 0:
                    keep.append(a)
                    rem //= mesh.shape[a]
            dspec = P(tuple(keep) if keep else None, None)
        else:
            pspecs = sh.param_specs(params, cfg, mesh)
            dspec = sh.data_specs(cfg, mesh, BATCH)
        psh = sh.to_shardings(pspecs, mesh)
        rep = NamedSharding(mesh, P())
        osh = ja.AdamWState(mu=psh, nu=psh, step=rep)
        dsh = NamedSharding(mesh, dspec)
        ins = [psh, osh, dsh, dsh]
        if frames is not None:
            ins.append(NamedSharding(mesh, P(dspec[0], None, None)))
        ba = dspec[0]
        ba = (ba,) if isinstance(ba, str) else (tuple(ba) if ba else ())
        ctx = sh.activation_sharding(mesh, ba)
        fn = jax.jit(step, in_shardings=tuple(ins),
                     out_shardings=(psh, osh, rep))
        params = jax.device_put(params, psh)
        opt = jax.device_put(opt, osh)
    else:
        import contextlib
        ctx = contextlib.nullcontext()
        fn = jax.jit(step)
    with ctx:
        for i in range(STEPS):
            tokens, labels = next(data)
            args = [params, opt, tokens, labels]
            if frames is not None:
                args.append(frames)
            params, opt, metrics = fn(*args)
            for k, v in metrics.items():
                out[f"{name}/{i}/metric/{k}"] = np.asarray(v, np.float32)
            put(f"{name}/{i}/params", params)
            put(f"{name}/{i}/mu", opt.mu)
            put(f"{name}/{i}/nu", opt.nu)
            out[f"{name}/{i}/step"] = np.asarray(opt.step)


for name, (arch, shape, strategy) in CASES.items():
    run(name, arch, shape, strategy, "float32")
# the reference's own sharded-vs-unsharded gaps (olmo, (2, 2))
run("olmo@1", "olmo_1b", None, "2d", "float32", sharded=False)
run("olmo_bf16", "olmo_1b", (2, 2), "2d", "bfloat16")
run("olmo_bf16@1", "olmo_1b", None, "2d", "bfloat16", sharded=False)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's small CPU steps (the suite runs
    several workers); both sides of a comparison run with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's runs (``_REFERENCE``), started in a subprocess when
    the module's first test starts, so that the tests that do not read
    them run meanwhile; -> (the process, its .npz path, its log)."""
    tmp = tmp_path_factory.mktemp("shard")
    path, weights = str(tmp / "ref.npz"), str(tmp / "weights.npz")
    np.savez(weights, **{
        f"{arch}:{dtype}{k}": v for arch, dtype in
        {(a, "float32") for a, _, _ in CASES.values()}
        | {("olmo_1b", "bfloat16")}
        for k, v in _flat(_weights(arch, dtype)).items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = str(tmp / "ref.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), path,
             repr((CASES, STEPS, BATCH, SEQ, ENC_LEN, OPT)), weights],
            stdout=out, stderr=subprocess.STDOUT, env=env)
    yield proc, path, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def ref(_reference_run) -> dict:
    """The reference's runs, keyed "case/step/what/leaf path"."""
    proc, path, log = _reference_run
    proc.wait(timeout=900)
    with open(log) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    with np.load(path) as z:
        return dict(z)


def _cfg(configs, arch, dtype="float32"):
    return dataclasses.replace(configs.get_reduced(arch), param_dtype=dtype,
                               compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype) -> dict:
    """The port's seeded weights of ``arch`` in the reference's layout
    (float32 NumPy): both sides start from them."""
    cfg = _cfg(tconfigs, arch, dtype)
    return convert.lm_params_to_numpy(
        tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _treedef(arch):
    shapes = jax.eval_shape(lambda: jm.init_params(
        jax.random.PRNGKey(0), jconfigs.get_reduced(arch)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return [jax.tree_util.keystr(p) for p, _ in leaves], treedef


def _ref_tree(ref, arch, prefix):
    keys, treedef = _treedef(arch)
    return jax.tree.unflatten(treedef, [ref[prefix + k] for k in keys])


def _mesh(shape):
    n = int(np.prod(shape))
    return tmesh.make_mesh_for([CPU] * n, model_parallel=shape[-1],
                               pods=shape[0] if len(shape) == 3 else 1)


def _batches(cfg):
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    frames = (torch.from_numpy(np.random.default_rng(11).standard_normal(
        (BATCH, ENC_LEN, cfg.d_model)).astype(np.float32))
        if cfg.enc_dec else None)
    return [tuple(torch.from_numpy(x) for x in next(data)) + (frames,)
            for _ in range(STEPS)]


def _sharded(cfg, tree, shape, strategy):
    """The reference's weights as the port's ``ShardedModel`` over a CPU
    mesh of ``shape``, and its sharded step."""
    mesh = _mesh(shape)
    whole = convert.lm_params_from_numpy(cfg, tree, "cpu")
    pspecs, dspec = tuning.mesh_specs(whole, cfg, mesh, BATCH, strategy)
    params = ShardedModel.from_model(whole, mesh, pspecs)
    step = tsteps.make_train_step(cfg, ta.AdamWConfig(**OPT), remat=True,
                                  mesh=mesh, pspecs=pspecs, dspec=dspec)
    return params, step


def _opt_from(params, ref, arch, i):
    """The reference's optimizer state after step ``i`` in ``params``'
    shards."""
    whole = convert.lm_opt_state_from_numpy(
        params.to_model(CPU), _ref_tree(ref, arch, f"{i}/mu"),
        _ref_tree(ref, arch, f"{i}/nu"), ref[f"{i}/step"])
    return ta.AdamWState(
        {n: params.shardings[n].shard(t) for n, t in whole.mu.items()},
        {n: params.shardings[n].shard(t) for n, t in whole.nu.items()},
        whole.step)


def _worst_ulps(want_tree, got_tree, ssm: bool) -> float:
    """The largest error of any leaf in f32 ulps of that leaf's scale,
    jamba's Mamba ``A_log`` and ``dt_bias`` counted at 64 / 192 of theirs
    (``SSM_ULPS``)."""
    worst = 0.0
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
            want_tree)[0], jax.tree.leaves(got_tree)):
        err = float(np.abs(w - g).max()) / ulp_of_scale(w, F32_BITS)
        if ssm and jax.tree_util.keystr(path).endswith(
                ("['A_log']", "['dt_bias']")):
            err *= MU_ULPS / SSM_ULPS
        worst = max(worst, err)
    return worst


def _max_abs(want_tree, got_tree) -> float:
    return max(float(np.abs(w - g).max()) for w, g in
               zip(jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)))


def _case_ref(ref, case):
    return {k[len(case) + 1:]: v for k, v in ref.items()
            if k.startswith(case + "/")}


def _random_grads(params: tm.Model, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(p.shape, generator=gen).to(p.dtype) * 1e-2
            for name, p in params.named_parameters()}


def _model(arch, dtype="float32"):
    cfg = _cfg(tconfigs, arch, dtype)
    return tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_shards_hold_only_their_slices():
    """Each position holds its ``shard_shape`` slice of every parameter
    and moment, and nothing whole: the bytes a position holds are the sum
    of its slices'.  A layer of a leaf whose period axis the reference
    shards (deepseek-v3's MLA ``wo`` over ``model``) is held by the
    positions of its period chunk only; the others hold an empty
    shard."""
    whole = _model("deepseek_v3_671b")
    mesh = _mesh((2, 2))
    specs = tsh.param_specs(whole, whole.cfg, mesh)
    params = ShardedModel.from_model(whole, mesh, specs)
    opt = ta.adamw_init_sharded(params)
    want_bytes = [0] * mesh.size
    split = empty = 0
    for name, p in whole.named_parameters():
        sh = params.shardings[name]
        shape = sh.shard_shape(p.shape)
        split += shape != tuple(p.shape)
        for pos, (s, m, v) in enumerate(zip(params.shards[name],
                                            opt.mu[name], opt.nu[name])):
            held = sh.holds(pos)
            empty += not held
            assert tuple(s.shape) == tuple(m.shape) == tuple(v.shape) \
                == (shape if held else sh.empty_shape(p.shape)), name
            assert m.dtype == v.dtype == torch.float32
            if held:
                assert_bitwise(p.detach()[sh.slices(pos, p.shape)], s, name)
            want_bytes[pos] += s.numel() * s.element_size()
    assert params.position_bytes() == want_bytes
    total = sum(p.numel() * p.element_size() for p in whole.parameters())
    assert split > 0 and empty > 0 and max(want_bytes) < total / 2, (
        want_bytes, total)
    back = params.to_model(CPU)
    for (name, a), (_, b) in zip(whole.named_parameters(),
                                 back.named_parameters()):
        assert_bitwise(a.detach(), b.detach(), name)


def test_replicated_copies_stay_bitwise_equal():
    """After a sharded step, the positions holding the same slice of a
    parameter (a norm scale, or a dimension no rule shards) hold equal
    bits, and so do their moments."""
    cfg = _cfg(tconfigs, "jamba_1_5_large_398b")
    params, step = _sharded(cfg, _weights("jamba_1_5_large_398b", "float32"),
                            (2, 2), "2d")
    opt = ta.adamw_init_sharded(params)
    tok, lab, _ = _batches(cfg)[0]
    params, opt, _ = step(params, opt, tok, lab)
    copies = 0
    for name, sh in params.shardings.items():
        first = {}
        for pos in filter(sh.holds, range(params.mesh.size)):
            src = first.setdefault(sh.chunk(pos), pos)
            if src == pos:
                continue
            copies += 1
            for held in (params.shards, opt.mu, opt.nu):
                assert_bitwise(held[name][src], held[name][pos], name)
    assert copies > 0


def test_aux_is_the_global_one():
    """The MoE aux of a sharded batch is the whole batch's (E x the sum of
    the products of two means over every token), not the mean of its
    shards' auxes: on a batch whose two shards route differently the
    sharded step's aux sits within 2 ulps of the one-position loss's,
    and the shards' mean is far from it."""
    cfg = _cfg(tconfigs, "grok_1_314b")
    whole = _model("grok_1_314b")
    tok, lab, _ = _batches(cfg)[0]
    with torch.no_grad():
        _, one = tm.loss_fn(whole, tok, lab, cfg)
        shards = []
        for rows in (slice(0, 2), slice(2, 4)):
            with tmoe.recording() as rec:
                shards.append(tm.loss_fn(whole, tok[rows], lab[rows],
                                         cfg)[1]["aux"])
            shards[-1] = (shards[-1], torch.stack(
                [torch.bincount(e.reshape(-1), minlength=cfg.n_experts)
                 for _, e in rec]))
    assert not torch.equal(shards[0][1], shards[1][1])   # routed apart
    mesh = _mesh((2, 2))
    params = ShardedModel.from_model(whole, mesh, tsh.param_specs(
        whole, cfg, mesh))
    step = tsteps.make_train_step(cfg, ta.AdamWConfig(**OPT), mesh=mesh)
    _, _, got = step(params, ta.adamw_init_sharded(params), tok, lab)
    unit = ulp_of_scale(one["aux"].item(), F32_BITS)
    err = abs(got["aux"].item() - one["aux"].item()) / unit
    mean = (shards[0][0] + shards[1][0]).item() / 2
    assert err <= OWN_LOSS_ULPS, err
    assert abs(mean - one["aux"].item()) / unit > 100 * OWN_LOSS_ULPS
    print(f"grok aux: whole batch {one['aux'].item():.8g}, sharded step "
          f"{got['aux'].item():.8g} ({err:.3g} ulps), mean of the shards' "
          f"{mean:.8g}")


def test_compress_scale_is_the_leafs_global_max():
    """``compress=True`` over shards: one int8 scale a reference leaf,
    from the largest magnitude over every shard of it (a pmax), so the
    round trip is bitwise the one-position round trip of the whole
    gradients, with the largest element in one position's slice."""
    whole = _model("olmo_1b")
    mesh = _mesh((2, 2))
    params = ShardedModel.from_model(whole, mesh, tsh.param_specs(
        whole, whole.cfg, mesh))
    grads = _random_grads(whole, 3)
    name = "blocks.0.mlp.wi"
    sh = params.shardings[name]
    assert len(sh.distinct()) > 1
    last = sh.slices(mesh.size - 1, grads[name].shape)
    grads[name][tuple(c.start for c in last)] = 7.0   # only that slice
    want = tsteps._compress_roundtrip(grads, whole)
    got = tsteps._compress_roundtrip_sharded(
        {n: params.shardings[n].shard(g) for n, g in grads.items()}, params)
    for n, g in want.items():
        for pos in filter(params.shardings[n].holds, range(mesh.size)):
            assert_bitwise(g[params.shardings[n].slices(pos, g.shape)],
                           got[n][pos], n)
    q, scale = tcomp.quantize_int8(grads[name].float())
    assert float(scale) == np.float32(7.0) / np.float32(127.0)


def test_adamw_on_shards_is_bitwise_the_unsharded_update():
    """Given the same gradients and clip scale (the clip inactive), AdamW
    on each position's shard is bitwise the slice of the unsharded
    update: parameters and both moments, over two steps."""
    whole = _model("deepseek_v3_671b")
    mesh = _mesh((2, 2))
    params = ShardedModel.from_model(whole, mesh, tsh.param_specs(
        whole, whole.cfg, mesh))
    cfg = ta.AdamWConfig(**dict(OPT, clip_norm=1e3))
    opt, opt1 = ta.adamw_init_sharded(params), ta.adamw_init(whole)
    for seed in (1, 2):
        grads = _random_grads(whole, seed)
        _, opt1, m1 = ta.adamw_update(cfg, grads, opt1, whole)
        params, opt, m = ta.adamw_update_sharded(
            cfg, {n: params.shardings[n].shard(g) for n, g in grads.items()},
            opt, params)
        assert m["lr"].item() == m1["lr"].item()
        assert float(m["grad_norm"]) < 1e3
    for name, p in whole.named_parameters():
        sh = params.shardings[name]
        for pos in filter(sh.holds, range(mesh.size)):
            cut = sh.slices(pos, p.shape)
            assert_bitwise(p.detach()[cut], params.shards[name][pos], name)
            assert_bitwise(opt1.mu[name][cut], opt.mu[name][pos], name)
            assert_bitwise(opt1.nu[name][cut], opt.nu[name][pos], name)
    assert int(opt.step) == int(opt1.step) == 2


def _ckpt(path) -> dict:
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files}


@pytest.mark.parametrize("first,then", [(4, None), (None, 4)],
                         ids=["mesh_to_one", "one_to_mesh"])
def test_restart_across_meshes(first, then, tmp_path):
    """A checkpoint holds whole tensors in a one-position run's layout: a
    (2, 2) run's step-3 checkpoint restored on one position (and the
    reverse) and saved again without a step is bitwise the checkpoint;
    the run then resumes there, its first step's loss within 16 f32 ulps
    of the straight run's (the same state, the other mesh's rounding;
    measured 1) and the step-6 data cursor and step count equal."""
    ckpt = str(tmp_path / "ck")

    def run(devices, steps):
        return ttrain.train("olmo_1b", steps=steps, batch=4, seq=32,
                            ckpt_dir=ckpt, ckpt_every=3, log_every=1,
                            lr=3e-3, device="cpu", devices=devices,
                            model_parallel=2 if devices else 1)

    straight = run(first, 6)
    final = os.path.join(ckpt, "ckpt_000000006.npz")
    shutil.move(final, str(tmp_path / "straight.npz"))
    three = os.path.join(ckpt, "ckpt_000000003.npz")
    shutil.copy(three, str(tmp_path / "three.npz"))
    assert run(then, 3)["losses"] == []           # restored, saved again
    want, got = _ckpt(str(tmp_path / "three.npz")), _ckpt(three)
    assert want.keys() == got.keys() and len(want) > 10
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], k)
    resumed = run(then, 6)
    assert len(resumed["losses"]) == 3 and np.isfinite(resumed["losses"]).all()
    a, b = straight["losses"][3], resumed["losses"][0]
    assert abs(a - b) <= 16 * ulp_of_scale(a, F32_BITS), (a, b)
    want, got = _ckpt(str(tmp_path / "straight.npz")), _ckpt(final)
    n_params = (json.loads(str(want["__meta__"]))["n_leaves"] - 3) // 3
    # leaves in sorted-key order: the data cursor, mu, nu, the step, params
    for k in ("leaf_0", "leaf_1", f"leaf_{2 + 2 * n_params}"):
        np.testing.assert_array_equal(want[k], got[k], k)
    print(f"{first} -> {then}: step-4 loss {a:.8g} straight, {b:.8g} "
          f"resumed; steps 5-6 {straight['losses'][4:]} / "
          f"{resumed['losses'][1:]}")


def test_train_over_a_mesh_loss_falls():
    """``train`` over a (2, 2) mesh of CPU positions: the reduced olmo's
    loss falls below 0.9 x its first step's in 40 steps (the trainer's
    own test on one position)."""
    out = ttrain.train("olmo_1b", steps=40, batch=4, seq=64, lr=3e-3,
                       log_every=1, device="cpu", devices=["cpu"] * 4,
                       model_parallel=2)
    losses = out["losses"]
    assert len(losses) == len(out["step_ms"]) == 40
    assert out["final_loss"] == losses[-1] < 0.9 * losses[0], losses


def test_main_over_a_mesh_prints_its_json_line_last(capsys):
    ttrain.main(["--steps", "2", "--batch", "4", "--seq", "16", "--device",
                 "cpu", "--devices", "4", "--model-parallel", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[train] step 2/2 loss=")
    out = json.loads(lines[-1])
    assert set(out) == {"final_loss"} and np.isfinite(out["final_loss"])


def test_production_mesh_and_hw():
    """The reference's production meshes as positions of one device
    (``meta`` by default), and the H100's figures."""
    one = tmesh.make_production_mesh()
    assert one.shape == {"data": 16, "model": 16}
    pods = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert set(one.device_list()) == {torch.device("meta")}
    assert set(pods.device_list()) == {CPU}
    assert tmesh.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                        "nvlink_bw": 450e9}
    # the data-parallel axes over the production mesh, as the reference's
    assert tsh.data_specs(None, pods, 256) == (("pod", "data"), None)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_is_the_references(case, ref):
    arch, shape, strategy = CASES[case]
    r = _case_ref(ref, case)
    cfg = _cfg(tconfigs, arch)
    lr = OPT["lr"]
    param_lr = JAMBA_PARAM_LR if arch == "jamba_1_5_large_398b" else PARAM_LR
    params, step = _sharded(cfg, _weights(arch, "float32"), shape, strategy)
    opt = ta.adamw_init_sharded(params)
    worst = {"loss": 0.0, "aux": 0.0, "norm": 0.0}
    for i, (tok, lab, frames) in enumerate(_batches(cfg)):
        params, opt, got = step(params, opt, tok, lab, frames)
        want = {k[len(f"{i}/metric/"):]: v for k, v in r.items()
                if k.startswith(f"{i}/metric/")}
        assert set(got) == set(want)
        unit = ulp_of_scale(want["loss"], F32_BITS)
        for k in set(want) - {"grad_norm", "lr", "aux"}:
            err = abs(float(want[k]) - got[k].item()) / unit
            worst["loss"] = max(worst["loss"], err)
            assert err <= LOSS_ULPS, (i, k, err)
        if float(want["aux"]):
            err = abs(float(want["aux"]) - got["aux"].item()) / ulp_of_scale(
                want["aux"], F32_BITS)
            worst["aux"] = max(worst["aux"], err)
            assert err <= AUX_ULPS, (i, err)
        norm = abs(float(want["grad_norm"]) - got["grad_norm"].item()) \
            / ulp_of_scale(want["grad_norm"], F32_BITS)
        worst["norm"] = max(worst["norm"], norm)
        assert norm <= NORM_ULPS, (i, norm)
        assert np.float32(want["lr"]) == np.float32(got["lr"].item())
    drift = _max_abs(_ref_tree(r, arch, f"{STEPS - 1}/params"),
                     convert.lm_params_to_numpy(params.to_model(CPU))) / lr
    assert drift <= param_lr, drift
    report = []
    for i, (tok, lab, frames) in enumerate(_batches(cfg)):
        prev = (_weights(arch, "float32") if i == 0
                else _ref_tree(r, arch, f"{i - 1}/params"))
        params, step = _sharded(cfg, prev, shape, strategy)
        opt = (ta.adamw_init_sharded(params) if i == 0
               else _opt_from(params, r, arch, i - 1))
        params, opt, _ = step(params, opt, tok, lab, frames)
        whole = ta.AdamWState(params.whole(opt.mu, CPU),
                              params.whole(opt.nu, CPU), opt.step)
        got_o = convert.lm_opt_state_to_numpy(params.meta, whole)
        assert int(got_o["step"]) == int(r[f"{i}/step"]) == i + 1
        p_err = _max_abs(_ref_tree(r, arch, f"{i}/params"),
                         convert.lm_params_to_numpy(params.to_model(CPU))) / lr
        ssm = arch == "jamba_1_5_large_398b"
        mu_err = _worst_ulps(_ref_tree(r, arch, f"{i}/mu"), got_o["mu"], ssm)
        nu_err = _worst_ulps(_ref_tree(r, arch, f"{i}/nu"), got_o["nu"], ssm)
        assert p_err <= param_lr and mu_err <= MU_ULPS and \
            nu_err <= NU_ULPS, (i, p_err, mu_err, nu_err)
        report.append(f"{p_err:.3g} lr / {mu_err:.3g} / {nu_err:.3g}")
    print(f"{case}: worst loss parts {worst['loss']:.3g} ulps, aux "
          f"{worst['aux']:.3g}, norm {worst['norm']:.3g}; two steps drift "
          f"{drift:.3g} lr; from the reference's state, params / mu / nu: "
          + ", ".join(report))


def _own_gap(cfg, tree, shape, strategy):
    """Two steps of the port's sharded step and of its one-position step
    from ``tree`` -> (worst loss-part ulps, worst norm ulps, parameter gap
    in lr)."""
    params, step = _sharded(cfg, tree, shape, strategy)
    opt = ta.adamw_init_sharded(params)
    one = convert.lm_params_from_numpy(cfg, tree, "cpu")
    one_opt = ta.adamw_init(one)
    one_step = tsteps.make_train_step(cfg, ta.AdamWConfig(**OPT), remat=True)
    loss_err = norm_err = 0.0
    for tok, lab, frames in _batches(cfg):
        params, opt, got = step(params, opt, tok, lab, frames)
        one, one_opt, want = one_step(one, one_opt, tok, lab, frames)
        unit = ulp_of_scale(want["loss"].item(), F32_BITS)
        for k in set(want) - {"grad_norm", "lr"}:
            loss_err = max(loss_err, abs(want[k].item() - got[k].item())
                           / unit)
        norm_err = max(norm_err, abs(want["grad_norm"].item()
                                     - got["grad_norm"].item())
                       / ulp_of_scale(want["grad_norm"].item(), F32_BITS))
        assert want["lr"].item() == got["lr"].item()
    whole = params.to_model(CPU)
    gap = max(float((a.detach() - b).abs().max()) for (_, a), (_, b) in
              zip(one.named_parameters(), whole.named_parameters()))
    return loss_err, norm_err, gap / OPT["lr"]


def _ref_gap(ref, name, arch) -> float:
    """The reference's own parameter gap, sharded against unsharded, after
    its two steps, in lr."""
    return _max_abs(_ref_tree(ref, arch, f"{name}/{STEPS - 1}/params"),
                    _ref_tree(ref, arch, f"{name}@1/{STEPS - 1}/params")) \
        / OPT["lr"]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_is_the_one_position_step(case, ref):
    arch, shape, strategy = CASES[case]
    cfg = _cfg(tconfigs, arch)
    loss_err, norm_err, gap = _own_gap(cfg, _weights(arch, "float32"), shape,
                                       strategy)
    assert loss_err <= OWN_LOSS_ULPS and norm_err <= OWN_NORM_ULPS, (
        loss_err, norm_err)
    assert gap <= OWN_PARAM_LR, gap
    print(f"{case}: sharded vs one position, loss parts {loss_err:.3g} "
          f"ulps, norm {norm_err:.3g} ulps, parameters {gap:.3g} lr (the "
          f"reference's own olmo gap {_ref_gap(ref, 'olmo', 'olmo_1b'):.3g} "
          "lr)")


def test_bf16_loss_gap_is_within_twice_the_references(ref):
    """At bfloat16 each step's loss may sit from the one-position step's
    by at most twice the reference's own sharded-vs-unsharded gap at that
    step plus one f32 ulp (the rule chip_smoke's [shard] applies to
    OLMo-1B's first step, ``SHARD_BF16_ULPS``; measured: the reference's
    22 and 565 ulps, the port's 1 and 186).  The parameters differ where
    a bf16 gradient that cancels to near zero rounds to another sign or
    size: Adam's first step then moves the element by up to 2 lr, and its
    bf16 parameter by up to one ulp more; every element is held there,
    and the elements that differ at all to ``SHARD_BF16_MOVED`` of the
    parameters (measured 2.05e-3)."""
    gaps = []
    for i in range(STEPS):
        a = float(ref[f"olmo_bf16/{i}/metric/loss"])
        b = float(ref[f"olmo_bf16@1/{i}/metric/loss"])
        gaps.append(abs(a - b) / ulp_of_scale(b, F32_BITS))
    cfg = _cfg(tconfigs, "olmo_1b", "bfloat16")
    tree = _weights("olmo_1b", "bfloat16")
    params, step = _sharded(cfg, tree, (2, 2), "2d")
    opt = ta.adamw_init_sharded(params)
    one = convert.lm_params_from_numpy(cfg, tree, "cpu")
    one_opt = ta.adamw_init(one)
    one_step = tsteps.make_train_step(cfg, ta.AdamWConfig(**OPT), remat=True)
    mine = []
    for i, (tok, lab, frames) in enumerate(_batches(cfg)):
        params, opt, got = step(params, opt, tok, lab, frames)
        one, one_opt, want = one_step(one, one_opt, tok, lab, frames)
        mine.append(abs(got["loss"].item() - want["loss"].item())
                    / ulp_of_scale(want["loss"].item(), F32_BITS))
        assert mine[-1] <= 2 * gaps[i] + 1, (i, mine, gaps)
        if i == 0:
            moved, worst = _bf16_param_gap(one, params.to_model(CPU),
                                           OPT["lr"])
    assert moved <= SHARD_BF16_MOVED and worst <= 1, (moved, worst)
    print(f"olmo bf16 (2, 2): the reference's sharded-vs-unsharded loss gap "
          f"{gaps} f32 ulps of the loss, the port's {mine}; after one step "
          f"{moved:.3g} of the parameters differ, the largest by "
          f"{worst:.3g} of (2 lr + 1 bf16 ulp)")


def _bf16_param_gap(want: tm.Model, got: tm.Model, lr: float):
    """(the share of elements that differ, the largest difference in units
    of 2 lr plus one bf16 ulp of the element)."""
    moved = total = 0
    worst = 0.0
    for a, b in zip(want.parameters(), got.parameters()):
        a, b = a.detach().float(), b.detach().float()
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
            torch.log2(a.abs().clamp_min(1e-30))))
        worst = max(worst, float(((a - b).abs() / (2 * lr + ulp)).max()))
        moved += int((a != b).sum())
        total += a.numel()
    return moved / total, worst
