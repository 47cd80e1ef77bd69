"""The port's dry run, repro_torch.launch.dryrun, and the sharded prefill
and decode steps it traces (launch/steps.py over a mesh).

- Bytes per position: for the ten published configs on the production
  meshes, (16, 16) and (2, 16, 16), with the "2d" strategy and with every
  distinct tuning of ``launch.tuning`` (its padded heads and its "fsdp"
  strategy), each position's parameters and AdamW moments (float32, two
  a parameter) in the shards of ``param_specs`` (what ``ShardedModel``
  holds, tests/test_torch_lm_shard.py) equal the reference's per-device
  bytes: the sum over its leaves of their
  shard bytes under its ``param_specs`` on a ``jax.sharding.
  AbstractMesh``.  A layer of a leaf whose period axis the reference
  shards (OLMo-1B's MLP ``wo`` over ``model``) is held on its period
  chunk's positions only, so the split is even.
- ``trace_cell`` writes the reference's record keys for the three step
  kinds of the reduced configs over (2, 2) and (4, 2) ``meta`` meshes;
  ``run_cell`` writes its JSON and reads it back; ``main`` exits 0.
- The sharded prefill and decode over a (2, 2) CPU mesh against the
  one-position steps from the same weights, at float32: bitwise the
  one-position steps run on each data-parallel group's rows (logits,
  tokens, caches), decode over ``cache_specs``' shards at batch 4 and
  with ``shard_seq`` (the cache's sequence over ``data``) at batch 1.
- Against the reference's jitted steps under ``NamedSharding``s, run
  once in a subprocess over eight forced host devices on an Auto-axes
  (2, 2) mesh (jax 0.9.0's default Explicit axes make its sharded jit
  raise ``ShardingTypeError``): olmo and deepseek-v3 (MLA, MoE) reduced,
  float32, from the port's seeded weights: prefill logits, then 8
  prompt and 3 greedy decode steps from an empty cache, their logits
  within 16 f32 ulps of the scale (the model tests' limit,
  tests/test_torch_lm_model.py) and tokens
  equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import dryrun, specs, steps, tuning  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.models.sharded import ShardedCache, ShardedModel  # noqa
from repro_torch.models.sharded import _leaves  # noqa: E402

from torch_parity import F32_BITS, assert_bitwise, ulp_of_scale  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
META = torch.device("meta")
ARCHS = sorted(tconfigs.ARCHS)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "devices", "tuning",
               "memory_analysis", "cost_analysis", "collectives",
               "roofline", "params_total", "params_active", "trace_s"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s",
                 "model_flops_total", "model_flops_per_device",
                 "useful_flops_ratio", "bottleneck"}
OWN_ULPS, REF_ULPS = 2, 16
BATCH, PROMPT, GEN = 4, 8, 3
REF_CASES = ("olmo_1b", "deepseek_v3_671b")



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's small CPU steps (the suite runs
    several workers, whose threads would contend); both sides of every
    port-to-port comparison run with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _mesh(shape, dev=CPU):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device(dev)] * devs.size
    names = ("pod", "data", "model")[-len(shape):]
    return Mesh(devs.reshape(shape), names)


def _tunings(arch: str) -> list:
    """(tuning overrides, strategy) of "2d" and of every distinct
    ``launch.tuning`` entry of ``arch``."""
    out = [({}, "2d")]
    for shape in specs.SHAPES:
        applied = dict(tuning.overrides_for(arch, shape) or {})
        strategy = applied.pop("mesh_strategy", "2d")
        if (applied, strategy) not in out:
            out.append((applied, strategy))
    return out


def _reference_bytes(cfg, params, shape, strategy) -> int:
    """The reference's per-device bytes of parameters (``params``: their
    shapes) and moments."""
    axes = ("pod", "data", "model")[-len(shape):]
    amesh = AbstractMesh(shape, axes)
    if strategy == "fsdp":
        pspecs = jsh.param_specs(params, cfg, amesh, fsdp_axis=axes,
                                 model_axis=None)
    else:
        pspecs = jsh.param_specs(params, cfg, amesh)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
            pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec))):
        n = int(np.prod(leaf.shape))
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= amesh.shape[a]
        total += n * (leaf.dtype.itemsize + 8)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_position_bytes_equal_the_references(arch):
    """Parameters and moments per position, published config, both
    production meshes, "2d" and tuned: every position's bytes equal the
    reference's per-device bytes."""
    for applied, strategy in _tunings(arch):
        jcfg = dataclasses.replace(jconfigs.get(arch), **applied)
        tcfg = dataclasses.replace(tconfigs.get(arch), **applied)
        meta = tm.Model(tcfg, None, META)
        shapes = jax.eval_shape(lambda: jm.init_params(
            jax.random.PRNGKey(0), jcfg))
        for shape in ((16, 16), (2, 16, 16)):
            mesh = _mesh(shape, META)
            pspecs, _ = tuning.mesh_specs(meta, tcfg, mesh, 256, strategy)
            got = [0] * mesh.size
            for name, sh in tsh.to_shardings(pspecs, mesh).items():
                p = meta.get_parameter(name)
                b = int(np.prod(sh.shard_shape(p.shape))) * (
                    p.element_size() + 8)
                for pos in filter(sh.holds, range(mesh.size)):
                    got[pos] += b
            want = _reference_bytes(jcfg, shapes, shape, strategy)
            assert set(got) == {want}, (arch, applied, strategy, shape,
                                        min(got), max(got), want)


def test_trace_cell_writes_the_references_keys():
    """``trace_cell`` of each reduced config's train, prefill and decode
    cell over (2, 2) and (4, 2) ``meta`` meshes: the reference's record
    keys, per-position figures, collectives that add up, and a sharded
    step's gathers and reductions counted."""
    cells = [(specs.ShapeCell("t", 16, 8, "train"), (2, 2)),
             (specs.ShapeCell("p", 16, 8, "prefill"), (4, 2)),
             (specs.ShapeCell("d", 16, 8, "decode"), (4, 2)),
             (specs.ShapeCell("d1", 16, 1, "decode"), (2, 2))]
    for arch in ARCHS:
        cfg = tconfigs.get_reduced(arch)
        for cell, shape in cells:
            rec = dryrun.trace_cell(cfg, cell, _mesh(shape, META))
            rec = {"arch": arch, "shape": cell.name, "mesh": "single",
                   "tuning": None, **rec}
            assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
            assert set(rec["roofline"]) == ROOFLINE_KEYS
            assert rec["devices"] == int(np.prod(shape))
            coll = dict(rec["collectives"])
            total, count = coll.pop("total"), coll.pop("count")
            assert total == sum(coll.values()) and count > 0
            assert "all-gather" in coll, (arch, cell)
            if cell.kind == "train":
                assert "reduce-scatter" in coll
            for v in rec["per_position"].values():
                assert len(v) == rec["devices"]
            assert rec["memory_analysis"]["argument_size_in_bytes"] == max(
                rec["per_position"]["argument_size_in_bytes"])
            assert rec["cost_analysis"]["flops"] > 0
            json.dumps(rec)


def test_run_cell_writes_and_reuses_its_json_and_main_exits_0(
        tmp_path, monkeypatch):
    """One production cell: ``run_cell`` writes its record, a second call
    reads it back without tracing; ``main`` on one cell exits 0 and
    writes the ``_tuned`` record with ``--tuned``."""
    out = str(tmp_path)
    rec = dryrun.run_cell("olmo_1b", "prefill_32k", False, out)
    path = os.path.join(out, "olmo_1b__prefill_32k__single.json")
    assert rec["status"] == "ok" and rec["devices"] == 256
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rec))

    def fail(*a, **k):
        raise AssertionError("traced again")

    with monkeypatch.context() as m:
        m.setattr(dryrun, "lower_cell", fail)
        assert dryrun.run_cell("olmo_1b", "prefill_32k", False, out) == \
            json.loads(json.dumps(rec))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "prefill_32k",
                     "--mesh", "single", "--out", out, "--tuned"])
    assert e.value.code == 0
    assert os.path.exists(os.path.join(
        out, "olmo_1b__prefill_32k__single_tuned.json"))


def _f32(configs, arch):
    return dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _weights(arch) -> tm.Model:
    return tm.init_params(_f32(tconfigs, arch),
                          torch.Generator().manual_seed(0), "cpu")


def _inputs(cfg, batch):
    g = np.random.default_rng(5)
    tok = torch.from_numpy(g.integers(0, cfg.vocab, (batch, PROMPT)).astype(
        np.int32))
    frames = (torch.from_numpy(g.standard_normal(
        (batch, 6, cfg.d_model)).astype(np.float32)) if cfg.enc_dec
        else None)
    return tok, frames


def _assert_ulps(want, got, limit, what):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    err = float(np.abs(want - got).max()) / ulp_of_scale(want, F32_BITS)
    assert err <= limit, (what, err)


def _groups(mesh, dspec, batch) -> list:
    """Each data-parallel group's rows, in batch order."""
    sh = tsh.Sharding(mesh, dspec)
    return sorted({sh.slices(p, (batch, 1))[0].start: sh.slices(
        p, (batch, 1))[0] for p in range(mesh.size)}.items())


def _assert_bitwise_tree(want, got, what):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert np.array_equal(np.asarray(a).view(np.int32)
                              if np.asarray(a).dtype == np.float32
                              else np.asarray(a),
                              np.asarray(b).view(np.int32)
                              if np.asarray(b).dtype == np.float32
                              else np.asarray(b)), (what, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_one_position(arch):
    """Over a (2, 2) CPU mesh from the same weights, float32: the sharded
    prefill's logits, the sharded decode's logits and tokens over 8
    prompt and 3 greedy steps, and its caches, bitwise the one-position
    steps run on each data-parallel group's rows (batch 4: two groups of
    two rows; batch 1 with the cache's sequence over ``data``: one
    group); the whole batch's one-position logits within 16 f32 ulps of
    the scale (the CPU's products round two rows otherwise than four:
    2.5 ulps measured for mamba2's decode)."""
    cfg = _f32(tconfigs, arch)
    whole = _weights(arch)
    mesh = _mesh((2, 2))
    for batch in (BATCH, 1):
        tok, frames = _inputs(cfg, batch)
        pspecs, dspec = tuning.mesh_specs(whole, cfg, mesh, batch, "2d")
        groups = _groups(mesh, dspec, batch)
        sp = ShardedModel.from_model(whole, mesh, pspecs)

        def fr(rows):
            return None if frames is None else frames[rows]

        with torch.no_grad():
            one = torch.cat([steps.make_prefill_step(cfg)(
                whole, tok[rows], fr(rows)) for _, rows in groups])
            full = steps.make_prefill_step(cfg)(whole, tok, frames)
        got = steps.make_prefill_step(cfg, mesh=mesh, pspecs=pspecs,
                                      dspec=dspec)(sp, tok, frames)
        got = tsh.Sharding(mesh, tuple(dspec) + (None,)).gather(got, CPU)
        _assert_bitwise_tree([one.numpy()], [got.numpy()],
                             f"{arch} prefill {batch}")
        _assert_ulps(full, got, REF_ULPS, f"{arch} prefill {batch}")

        def cache(rows):
            c = tm.init_cache(cfg, rows.stop - rows.start, 16, CPU,
                              enc_len=0 if frames is None
                              else frames.shape[1])
            if cfg.enc_dec:
                c = tm.fill_cross_caches(whole, c, tm.encode(
                    whole, fr(rows), cfg), cfg)
            return c

        caches = [cache(rows) for _, rows in groups]
        start = cache(slice(0, batch))
        cspecs = tsh.cache_specs(start, cfg, mesh, batch,
                                 shard_seq=batch == 1)
        sc = ShardedCache.from_cache(start, mesh, cspecs)
        decode = steps._sharded_decode_step(cfg, mesh, pspecs, dspec, cspecs)
        serve = steps.make_serve_step(cfg, mesh=mesh, pspecs=pspecs,
                                      dspec=dspec, cspecs=cspecs)
        x = tok[:, :1]
        with torch.no_grad():
            for t in range(PROMPT + GEN):
                if t + 1 >= PROMPT:
                    # the serve step (on a copy of the caches) picks the
                    # argmax of the sharded decode's logits
                    copy = ShardedCache.from_cache(sc.whole(CPU), mesh,
                                                   cspecs)
                    picked = serve(sp, x, copy)[0]
                want = []
                for k, (_, rows) in enumerate(groups):
                    lg, caches[k] = tm.decode_step(whole, x[rows],
                                                   caches[k], cfg)
                    want.append(lg)
                want = torch.cat(want)
                logits, _ = decode(sp, x, sc)
                _assert_bitwise_tree([want.numpy()], [logits.numpy()],
                                     f"{arch} decode {t}")
                x = (tok[:, t + 1:t + 2] if t + 1 < PROMPT else
                     torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
                if t + 1 >= PROMPT:
                    assert torch.equal(picked, x), (arch, t)
        back = sc.whole(CPU)
        for (_, rows), c in zip(groups, caches):
            assert int(c["step"]) == int(back["step"]) == PROMPT + GEN
            for lw, lg in zip(back["layers"], c["layers"]):
                for (path, a), (_, b) in zip(_leaves(lg), _leaves(lw)):
                    assert_bitwise(a, b if b.dim() == 0 else b[rows],
                                   f"{arch} cache {path}")


_REFERENCE = """
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch import steps as st
from repro.models import model as jm, sharding as sh
CASES, BATCH, PROMPT, GEN = eval(sys.argv[2])
W = np.load(sys.argv[3])
TOK = np.load(sys.argv[4])
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
for arch in CASES:
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32", compute_dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params = jax.tree.unflatten(treedef, [jnp.asarray(
        W[arch + jax.tree_util.keystr(p)], x.dtype) for p, x in leaves])
    pspecs = sh.param_specs(params, cfg, mesh)
    dspec = sh.data_specs(cfg, mesh, BATCH)
    psh = sh.to_shardings(pspecs, mesh)
    dsh = NamedSharding(mesh, dspec)
    params = jax.device_put(params, psh)
    tok = TOK[arch]
    caches = jm.init_cache(cfg, BATCH, 16)
    cspec = sh.cache_specs(caches, cfg, mesh, BATCH)
    csh = sh.to_shardings(cspec, mesh)
    tsh = NamedSharding(mesh, P(dspec[0], None))
    lsh = NamedSharding(mesh, P(dspec[0], None, None))
    with sh.activation_sharding(mesh, (dspec[0],)):
        pre = jax.jit(st.make_prefill_step(cfg), in_shardings=(psh, dsh),
                      out_shardings=lsh)
        out[arch + "/prefill"] = np.asarray(pre(params, tok))
        dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, cfg),
                      in_shardings=(psh, tsh, csh),
                      out_shardings=(lsh, csh))
        caches = jax.device_put(caches, csh)
        x = tok[:, :1]
        for t in range(PROMPT + GEN):
            logits, caches = dec(params, x, caches)
            out[f"{arch}/decode/{t}"] = np.asarray(logits)
            x = (tok[:, t + 1:t + 2] if t + 1 < PROMPT else np.asarray(
                jnp.argmax(logits[:, -1], -1).astype(jnp.int32))[:, None])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    path = str(tmp / "ref.npz")
    weights, tokens = str(tmp / "w.npz"), str(tmp / "tok.npz")
    flat = {}
    for arch in REF_CASES:
        tree = convert.lm_params_to_numpy(_weights(arch))
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[arch + jax.tree_util.keystr(p)] = np.asarray(x)
    np.savez(weights, **flat)
    np.savez(tokens, **{a: _inputs(_f32(tconfigs, a), BATCH)[0].numpy()
                        for a in REF_CASES})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), path,
         repr((REF_CASES, BATCH, PROMPT, GEN)), weights, tokens],
        capture_output=True, text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def test_sharded_prefill_and_decode_equal_the_references(ref):
    """olmo and deepseek-v3 reduced at float32 on a (2, 2) mesh: the
    sharded prefill's logits and the sharded decode's, 8 prompt steps
    and 3 greedy ones from an empty cache, within 16 f32 ulps of the
    reference's jitted steps under ``NamedSharding``s; tokens equal."""
    mesh = _mesh((2, 2))
    for arch in REF_CASES:
        cfg = _f32(tconfigs, arch)
        whole = _weights(arch)
        tok, _ = _inputs(cfg, BATCH)
        pspecs, dspec = tuning.mesh_specs(whole, cfg, mesh, BATCH, "2d")
        sp = ShardedModel.from_model(whole, mesh, pspecs)
        got = steps.make_prefill_step(cfg, mesh=mesh, pspecs=pspecs,
                                      dspec=dspec)(sp, tok)
        got = tsh.Sharding(mesh, tuple(dspec) + (None,)).gather(got, CPU)
        _assert_ulps(ref[arch + "/prefill"], got, REF_ULPS,
                     f"{arch} prefill")
        caches = tm.init_cache(cfg, BATCH, 16, CPU)
        cspecs = tsh.cache_specs(caches, cfg, mesh, BATCH)
        sc = ShardedCache.from_cache(caches, mesh, cspecs)
        decode = steps._sharded_decode_step(cfg, mesh, pspecs, dspec, cspecs)
        x = tok[:, :1]
        for t in range(PROMPT + GEN):
            logits, sc = decode(sp, x, sc)
            want = ref[f"{arch}/decode/{t}"]
            _assert_ulps(want, logits, REF_ULPS, f"{arch} decode {t}")
            if t + 1 < PROMPT:
                x = tok[:, t + 1:t + 2]
            else:
                x = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
                assert np.array_equal(x.numpy()[:, 0],
                                      np.argmax(want[:, -1], -1)), t
