"""Port parity for the LM's shapes and layouts: repro_torch.launch.specs,
repro_torch.launch.tuning, repro_torch.models.sharding.cache_specs and
the activation constraints against the reference's, and every arch
training over a mesh of CPU positions.

The reference's spec functions read only ``mesh.shape``, so they run on a
``jax.sharding.AbstractMesh`` and need no devices; the port's run on a
``Mesh`` of ``meta`` positions.  For each of the ten published configs:
``abstract_params`` leaf by leaf against ``jax.eval_shape`` of the
reference's ``init_params`` (through ``model.reference_path``: the
reference stacks the periodic body and the encoder), equal parameter
counts; ``abstract_opt_state``; ``input_specs`` of every shape cell (the
decode caches at 32k and 500k leaf by leaf); ``cache_specs`` of those
caches on (2, 4) and (16, 16) meshes with ``shard_seq`` both ways (the
period axis dropped, as for parameters).  ``TUNED`` / ``overrides_for``
for every (arch, shape).  The activation constraints recorded by the
port's loss inside ``activation_sharding`` for olmo and grok-1 (MoE)
reduced on a (2, 2) mesh: the reference's, recorded by tracing its loss
with ``with_sharding_constraint`` replaced by a recorder, its scanned body
once for every period.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import tuning as jtuning  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import tuning as ttuning  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)
META = torch.device("meta")
MESHES = ((2, 4), (16, 16))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta_mesh(shape):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [META] * arr.size
    return tmesh.Mesh(arr.reshape(shape), ("data", "model"))


def _entry(e):
    """A PartitionSpec entry as the port writes it: one axis alone is its
    name."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _spec(spec) -> tuple:
    return tuple(_entry(e) for e in spec)


def _dtype(x) -> torch.dtype:
    return DTYPES[np.dtype(x.dtype).name if x.dtype != jax.numpy.bfloat16
                  else "bfloat16"]


def _ref_cache_leaf(ref: dict, cfg, layer: int, keys: tuple):
    """The reference cache's leaf (and whether it is stacked) for the
    port's unrolled ``layer`` and keys below it."""
    n_prefix = len(cfg.prefix)
    if layer < n_prefix:
        node, stacked = ref["prefix"][layer], False
    else:
        node = ref["blocks"][(layer - n_prefix) % len(cfg.period)]
        stacked = True
    for k in keys:
        node = node[k]
    return node, stacked


def _leaves(tree, keys=()):
    """(keys, leaf) of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


def _check_caches(jcfg, tcfg, cell):
    b, s = cell.global_batch, cell.seq_len
    want = jspecs.input_specs(jcfg, cell.name)["caches"]
    got = tspecs.input_specs(tcfg, cell.name)["caches"]
    assert got["step"].shape == want["step"].shape == ()
    seen = set()
    for i, layer in enumerate(got["layers"]):
        for keys, t in _leaves(layer):
            w, stacked = _ref_cache_leaf(want, tcfg, i, keys)
            shape = tuple(w.shape[1:] if stacked else w.shape)
            assert (tuple(t.shape), t.dtype) == (shape, _dtype(w)), keys
            assert t.device == META
            seen.add(id(w))
    # every reference leaf but the step is some layer's
    assert len(seen) == len(jax.tree.leaves(want)) - 1
    for shape in MESHES:
        amesh = AbstractMesh(shape, ("data", "model"))
        mesh = _meta_mesh(shape)
        for seq in (False, True):
            ws = jsh.cache_specs(want, jcfg, amesh, b, shard_seq=seq)
            gs = tsh.cache_specs(got, tcfg, mesh, b, shard_seq=seq)
            assert gs["step"] == _spec(ws["step"]) == ()
            for i, layer in enumerate(gs["layers"]):
                for keys, spec in _leaves(layer):
                    w, stacked = _ref_cache_leaf(ws, tcfg, i, keys)
                    w = _spec(w)
                    if stacked:
                        assert w[0] is None, (keys, w)
                        w = w[1:]
                    assert spec == w, (cell.name, shape, seq, i, keys)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_are_the_references(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    params = tspecs.abstract_params(tcfg)
    count = 0
    for path, stack, names in ta.reference_leaves(params):
        key = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                      for k in path)
        w = want.pop(key)
        for name in names:
            p = params.get_parameter(name)
            assert p.device == META
            assert ((stack,) if stack else ()) + tuple(p.shape) == \
                tuple(w.shape), name
            assert p.dtype == _dtype(w), name
            count += p.numel()
    assert not want, sorted(want)
    assert count == sum(int(np.prod(x.shape)) for x in
                        jax.tree.leaves(shapes))
    opt = tspecs.abstract_opt_state(params)
    for name, p in params.named_parameters():
        assert opt.mu[name].shape == opt.nu[name].shape == p.shape
        assert opt.mu[name].dtype == torch.float32
    for name, cell in tspecs.SHAPES.items():
        assert tspecs.cell_applicable(tcfg, name) == \
            jspecs.cell_applicable(jcfg, name)
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jspecs.SHAPES[name])
        w, g = jspecs.input_specs(jcfg, name), tspecs.input_specs(tcfg, name)
        assert set(w) == set(g)
        for k in set(w) - {"caches"}:
            assert (tuple(g[k].shape), g[k].dtype) == (
                tuple(w[k].shape), _dtype(w[k])), (name, k)
        if "caches" in w and tspecs.cell_applicable(tcfg, name)[0]:
            _check_caches(jcfg, tcfg, cell)
    assert tspecs.ENC_FRAMES == jspecs.ENC_FRAMES


def test_tuned_overrides_are_the_references():
    assert ttuning.TUNED == jtuning.TUNED
    for arch in ARCHS:
        for shape in tspecs.SHAPES:
            assert ttuning.overrides_for(arch, shape) == \
                jtuning.overrides_for(arch, shape), (arch, shape)
    mesh = tmesh.make_mesh_for(["cpu"] * 4, model_parallel=2)
    params = tm.Model(tconfigs.get_reduced("olmo_1b"), None, META)
    pspecs, dspec = ttuning.mesh_specs(params, params.cfg, mesh, 4, "fsdp")
    assert dspec == (("data", "model"), None)
    assert pspecs["blocks.0.mlp.wi"] == (("data", "model"), None)
    with pytest.raises(ValueError, match="strategy"):
        ttuning.mesh_specs(params, params.cfg, mesh, 4, "3d")


def _reference_constraints(arch, batch, seq, monkeypatch) -> list:
    """(function, shape, spec) of every constraint the reference's loss
    pins on a (2, 2) mesh, in trace order."""
    cfg = dataclasses.replace(jconfigs.get_reduced(arch),
                              param_dtype="float32", compute_dtype="float32")
    record, kind = [], [None]
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: record.append(
                            (kind[0], tuple(x.shape), _spec(s.spec))) or x)
    for name in ("constrain_tokens", "constrain_expert_batch",
                 "constrain_combine"):
        def wrapped(x, fn=getattr(jsh, name), name=name):
            kind[0] = name
            return fn(x)
        monkeypatch.setattr(jsh, name, wrapped)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tok = jax.ShapeDtypeStruct((batch, seq), np.int32)
    with jsh.activation_sharding(AbstractMesh((2, 2), ("data", "model")),
                                 ("data",)):
        jax.eval_shape(lambda p, t: jm.loss_fn(p, t, t, cfg), shapes, tok)
    return record


@pytest.mark.parametrize("arch", ["olmo_1b", "grok_1_314b"])
def test_constraint_specs_are_the_references(arch, monkeypatch):
    """Inside ``activation_sharding`` the port's loss records the specs the
    reference pins (its scanned body once for every period); a batch
    shard seen with ``shards=2`` records the whole batch's shapes; outside
    the context nothing is recorded and each call returns its tensor."""
    b, s = 4, 32
    want = _reference_constraints(arch, b, s, monkeypatch)
    cfg = dataclasses.replace(tconfigs.get_reduced(arch),
                              param_dtype="float32", compute_dtype="float32")
    assert not cfg.prefix
    want = want[:1] + want[1:] * cfg.n_periods
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = tmesh.make_mesh_for(["cpu"] * 4, model_parallel=2)
    tok = torch.zeros((b, s), dtype=torch.int32)
    with torch.no_grad():
        with tsh.activation_sharding(mesh, ("data",)) as got:
            tm.loss_fn(params, tok, tok, cfg)
        with tsh.activation_sharding(mesh, ("data",), shards=2) as half:
            tm.loss_fn(params, tok[:2], tok[:2], cfg)
    assert got == want, (got, want)
    assert half == want
    x = torch.zeros((b, 4, 8, 16))
    for fn in (tsh.constrain_tokens, tsh.constrain_expert_batch,
               tsh.constrain_combine):
        assert fn(x) is x
    with tsh.activation_sharding(mesh, ("data",)) as rec:
        assert tsh.constrain_tokens(x[:3]) is not None and rec == []
        assert tsh.constrain_combine(x) is x
    assert rec == [("constrain_combine", (b, 4, 8, 16),
                    ("data", None, None, None))]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_trains_on_a_mesh(arch):
    """Two steps of every reduced arch on a (2, 2) mesh of CPU positions
    (whisper on the stub frames)."""
    out = ttrain.train(arch, steps=2, batch=4, seq=16, log_every=1,
                       device="cpu", devices=["cpu"] * 4, model_parallel=2)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    vocab = tconfigs.get_reduced(arch).vocab
    assert 0 < out["losses"][0] < 2 * np.log(vocab)
