"""Multi-device ACO: ``repro_torch.core.islands`` and its collectives,
checkpoint resharding and gradient compression, against the reference.

The reference's outputs come from the reference itself, run once per
module in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` (the pattern of ``tests/test_distributed.py``), which
writes them to an ``.npz``.  The port runs the same cases in this process
on meshes whose positions repeat ``cpu`` (``Mesh([cpu] * D, ...)``).  The
reference's island states are read as ``np.asarray`` of the stacked
fields, never through its ``global_best`` (which raises under jax 0.9.0
on sharded states).

Tolerances: the collectives, the island model on the pure route
(migration only, mixing, 2-opt polish) and the city-sharded colony's
plain slab deposit are bitwise.  On the kernel route the reference's
Pallas update in interpret mode fuses evaporation into the deposit, so
tau is held at rtol 1e-5 / atol 1e-7 there, with tours, lengths and keys
bitwise.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import collectives, islands  # noqa: E402
from repro_torch.core import sampling, tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

from torch_parity import assert_bitwise  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-7

# island cases: (name, island count, instance (kind, n, seed), ACOConfig
# kwargs, IslandConfig kwargs)
ISLANDS = {
    "migrate": (4, ("circle", 24, 5), dict(variant="mmas", rho=0.1),
                dict(exchange_every=2, rounds=2, mix_lambda=0.0)),
    "migrate8": (8, ("circle", 24, 5), dict(variant="mmas", rho=0.1),
                 dict(exchange_every=2, rounds=2, mix_lambda=0.0)),
    "mix": (4, ("circle", 24, 5), dict(variant="mmas", rho=0.1),
            dict(exchange_every=2, rounds=2, mix_lambda=0.1)),
    "mix3": (3, ("random", 24, 2), dict(variant="as", rho=0.1),
             dict(exchange_every=2, rounds=2, mix_lambda=0.25)),
    "mix8": (8, ("circle", 24, 5), dict(variant="acs", rho=0.1),
             dict(exchange_every=2, rounds=2, mix_lambda=0.1)),
    # the reference's own failing 4-device case, compared on its outputs
    "polish": (4, ("circle", 48, 5),
               dict(selection="gumbel", local_search="2opt",
                    ls_tours="iteration_best", ls_rounds=16),
               dict(exchange_every=3, rounds=2, mix_lambda=0.1)),
    "kernel": (4, ("circle", 24, 5), dict(variant="as", rho=0.1,
                                          use_pallas=True),
               dict(exchange_every=2, rounds=2, mix_lambda=0.1)),
}
# sharded colony cases: (name, mesh shape (data, model), ants_axis,
# use_pallas); n = 48, random_instance(48, seed=7), rho 0.1, seed 3
SHARDED = {
    "s4": ((1, 4), None, False),
    "ants": ((2, 4), "data", False),
    "s3": ((1, 3), None, False),
    "s4_kernel": ((1, 4), None, True),
    "ants_kernel": ((2, 4), "data", True),
}
SC_N, SC_STEPS = 48, 2
COLLECTIVE_DS = (2, 3, 4, 8)

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import checkpoint as ck
from repro.core import aco, islands, tsp
from repro.optim import compression
ISLANDS, SHARDED, SC_N, SC_STEPS, DS = eval(sys.argv[2])
out = {}
rng = np.random.RandomState(0)
for d in DS:
    mesh = Mesh(np.array(jax.devices()[:d]), ("data",))
    x = (rng.standard_normal((d, 257))
         * 10.0 ** rng.randint(-4, 4, (d, 257))).astype(np.float32)
    out[f"coll{d}_x"] = x
    for op in ("psum", "pmean", "pmax", "pmin"):
        f = jax.jit(shard_map(
            lambda v, op=op: getattr(jax.lax, op)(v, "data"), mesh=mesh,
            in_specs=P("data"), out_specs=P("data"), check_rep=False))
        out[f"coll{d}_{op}"] = np.asarray(f(x)).reshape(d, 257)
def make(kind, n, seed):
    return (tsp.circle_instance if kind == "circle"
            else tsp.random_instance)(n, seed=seed)
for name, (d, inst, akw, ikw) in ISLANDS.items():
    mesh = jax.make_mesh((d,), ("data",))
    cfg = islands.IslandConfig(aco=aco.ACOConfig(**akw), **ikw)
    st = islands.run_islands(make(*inst), cfg, mesh)
    for f in st._fields:
        out[f"isl_{name}_{f}"] = np.asarray(getattr(st, f))
inst = tsp.circle_instance(24, seed=1)
st = islands.init_island_states(inst, islands.IslandConfig(), 4)
st = st._replace(best_len=jnp.asarray([3.0, 1.0, 2.0, 1.0], jnp.float32))
for n_new in (2, 4, 6):
    r = ck.reshard_islands(st, n_new)
    for f in r._fields:
        out[f"reshard{n_new}_{f}"] = np.asarray(getattr(r, f))
inst = tsp.random_instance(SC_N, seed=7)
for name, (shape, ants, up) in SHARDED.items():
    mesh = jax.make_mesh(shape, ("data", "model"))
    cfg = aco.ACOConfig(rho=0.1, seed=3)
    st = islands.init_sharded_colony(inst, cfg, mesh, "model")
    sh = NamedSharding(mesh, P(None, "model"))
    d = jnp.asarray(inst.distances())
    eta = tsp.heuristic_matrix(d)
    d, eta = jax.device_put(d, sh), jax.device_put(eta, sh)
    step = islands.sharded_colony_step_fn(mesh, SC_N, cfg, "model",
                                          use_pallas=up, ants_axis=ants)
    for t in range(SC_STEPS):
        st, il = step(d, eta, st)
        out[f"sc_{name}_{t}_il"] = np.asarray(il)
        for f in st._fields:
            out[f"sc_{name}_{t}_{f}"] = np.asarray(getattr(st, f))
mesh = jax.make_mesh((1, 4), ("data", "model"))
st = islands.run_sharded_colony(inst, aco.ACOConfig(rho=0.1, seed=5), mesh,
                                iterations=3)
for f in st._fields:
    out[f"run_sc_{f}"] = np.asarray(getattr(st, f))
g = np.random.RandomState(1)
grads = {"w": (g.standard_normal((16, 16)) * 1e-2).astype(np.float32),
         "b": (g.standard_normal((7,)) * 1e-4).astype(np.float32)}
out["grads_w"], out["grads_b"] = grads["w"], grads["b"]
for tag, key in (("nokey", None), ("key", jax.random.PRNGKey(3))):
    state = None
    for t in range(2):
        q, s, state = compression.compress_grads(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, key)
        back = compression.decompress_grads(q, s)
        for k in grads:
            out[f"comp_{tag}{t}_q_{k}"] = np.asarray(q[k])
            out[f"comp_{tag}{t}_s_{k}"] = np.asarray(s[k])
            out[f"comp_{tag}{t}_err_{k}"] = np.asarray(state.error[k])
            out[f"comp_{tag}{t}_back_{k}"] = np.asarray(back[k])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("islands") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = repr((ISLANDS, SHARDED, SC_N, SC_STEPS, COLLECTIVE_DS))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          path, args], capture_output=True, text=True,
                         env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _mesh(shape, names):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [CPU] * devs.size
    return Mesh(devs.reshape(shape), names)


def _instance(kind, n, seed):
    return (ttsp.circle_instance if kind == "circle"
            else ttsp.random_instance)(n, seed=seed)


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("d", COLLECTIVE_DS)
@pytest.mark.parametrize("op", ["psum", "pmean", "pmax", "pmin"])
def test_reductions_bitwise_xla_order(ref, d, op):
    """psum left to right and pmean as that sum times float32(1/D) are
    bitwise XLA's CPU all-reduce over D forced host devices, D = 3
    included (where dividing by D would differ); every position gets the
    same value."""
    x = ref[f"coll{d}_x"]
    got = getattr(collectives, op)([torch.from_numpy(r) for r in x],
                                   "data", _mesh((d,), ("data",)))
    for row in range(d):
        assert_bitwise(ref[f"coll{d}_{op}"][row], got[row], f"{op} D={d}")


def test_ppermute_gather_and_groups_over_two_axes():
    """On a (2, 4) mesh a collective over one axis runs within each row
    or column; ppermute moves values along the ring and zero-fills a
    position that receives nothing; axis_index counts within groups."""
    mesh = _mesh((2, 4), ("data", "model"))
    xs = [torch.full((3,), float(i)) for i in range(8)]
    assert collectives.axis_index("model", mesh) == [0, 1, 2, 3] * 2
    assert collectives.axis_index("data", mesh) == [0] * 4 + [1] * 4
    s = collectives.psum(xs, "model", mesh)
    assert [float(v[0]) for v in s] == [6.0] * 4 + [22.0] * 4
    s = collectives.psum(xs, "data", mesh)
    assert [float(v[0]) for v in s] == [4.0, 6.0, 8.0, 10.0] * 2
    s = collectives.psum(xs, ("data", "model"), mesh)
    assert [float(v[0]) for v in s] == [28.0] * 8
    ring = collectives.ppermute(xs, "model", [(i, (i + 1) % 4)
                                              for i in range(4)], mesh)
    assert [float(v[0]) for v in ring] == [3, 0, 1, 2, 7, 4, 5, 6]
    part = collectives.ppermute(xs, "data", [(0, 1)], mesh)
    assert [float(v[0]) for v in part] == [0, 0, 0, 0, 0, 1, 2, 3]
    g = collectives.all_gather(xs, "data", mesh)
    assert g[5].shape == (2, 3) and g[5][:, 0].tolist() == [1.0, 5.0]


# ------------------------------------------------------------ island model
@pytest.mark.parametrize("name", sorted(ISLANDS))
def test_islands_equal_reference(ref, name):
    """run_islands on a D-position cpu mesh against the reference's
    D-device run: best tours, lengths, iterations and keys bitwise; tau
    bitwise on the pure route (the pmean order and the one-rounding mix
    reproduce XLA's), at rtol 1e-5 / atol 1e-7 on the kernel route."""
    d, inst, akw, ikw = ISLANDS[name]
    cfg = islands.IslandConfig(aco=taco.ACOConfig(**akw), **ikw)
    st = islands.run_islands(_instance(*inst), cfg, _mesh((d,), ("data",)))
    want = convert.states_from_numpy(device="cpu", **{
        f: ref[f"isl_{name}_{f}"] for f in taco.ColonyState._fields})
    for f in ("best_tour", "best_len", "iteration", "key"):
        assert_bitwise(getattr(want, f), getattr(st, f), f"{name} {f}")
    if akw.get("use_pallas"):
        torch.testing.assert_close(st.tau, want.tau, rtol=RTOL, atol=ATOL)
    else:
        assert_bitwise(want.tau, st.tau, f"{name} tau")
    tour, best = islands.global_best(st)
    i = int(np.argmin(ref[f"isl_{name}_best_len"]))
    assert best == float(ref[f"isl_{name}_best_len"][i])
    np.testing.assert_array_equal(tour, ref[f"isl_{name}_best_tour"][i])
    assert ttsp.is_valid_tour(tour)


def test_islands_checkpoint_resume_and_per_position_states(tmp_path):
    """A checkpoint written after round 0 and restored one island per
    position resumes to the uninterrupted run bitwise; checkpoint_cb sees
    one stacked state per round."""
    inst = ttsp.circle_instance(24, seed=3)
    mesh = _mesh((4,), ("data",))
    cfg = islands.IslandConfig(aco=taco.ACOConfig(variant="mmas", rho=0.1),
                               exchange_every=2, rounds=2)
    mgr = tck.CheckpointManager(str(tmp_path), async_write=False)
    seen = []

    def cb(state, r):
        seen.append(r)
        mgr.save(r, state)
    full = islands.run_islands(inst, cfg, mesh, checkpoint_cb=cb)
    assert seen == [0, 1]
    template = islands.init_island_states(inst, cfg, 4, device="cpu")
    per_pos, step = mgr.restore(template, step=0, shardings=[CPU] * 4)
    assert step == 0 and len(per_pos) == 4
    assert per_pos[2].tau.shape == (24, 24)
    resumed = islands.run_islands(
        inst, islands.IslandConfig(aco=cfg.aco, exchange_every=2, rounds=1),
        mesh, state=per_pos)
    for a, b in zip(tree.flatten(full), tree.flatten(resumed)):
        assert_bitwise(a, b, "resume")


def test_islands_reject_quantised_and_single_island_skips_exchange():
    inst = ttsp.circle_instance(16, seed=0)
    with pytest.raises(tops.UnsupportedKernelRoute, match="quantised"):
        islands.run_islands(inst, islands.IslandConfig(
            aco=taco.ACOConfig(tau_dtype="int8")), _mesh((2,), ("data",)))
    # one island: the exchange returns early, the colony runs alone
    cfg = islands.IslandConfig(aco=taco.ACOConfig(), exchange_every=3,
                               rounds=2, mix_lambda=0.5)
    st = islands.run_islands(inst, cfg, _mesh((1,), ("data",)))
    solo = taco.run(inst, taco.ACOConfig(iterations=6), device="cpu")
    for f in taco.ColonyState._fields:
        assert_bitwise(getattr(solo, f), getattr(st, f)[0], f)


# ------------------------------------------------------- sharded colony
@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_colony_step_equals_reference(ref, name):
    """Two city-sharded steps against sharded_colony_step_fn: iteration
    best, best tour and length and key bitwise; tau bitwise on the plain
    slab deposit (index_put_ onto the evaporated slab, or, over an ants
    axis, the psum'd deposit added with one rounding), at rtol 1e-5 /
    atol 1e-7 through the edge-stream kernel's route."""
    shape, ants, up = SHARDED[name]
    mesh = _mesh(shape, ("data", "model"))
    inst = ttsp.random_instance(SC_N, seed=7)
    cfg = taco.ACOConfig(rho=0.1, seed=3)
    st = islands.init_sharded_colony(inst, cfg, mesh, "model")
    d = torch.from_numpy(inst.distances())
    dl = islands.shard_columns(d, mesh)
    el = islands.shard_columns(ttsp.heuristic_matrix(d), mesh)
    step = islands.sharded_colony_step_fn(mesh, SC_N, cfg, "model",
                                          use_pallas=up, ants_axis=ants)
    for t in range(SC_STEPS):
        st, il = step(dl, el, st)
        p = f"sc_{name}_{t}_"
        assert_bitwise(ref[p + "il"], il, "iteration best")
        got = convert.sharded_state_to_numpy(st, mesh)
        for f in ("best_tour", "best_len", "iteration", "key"):
            assert_bitwise(ref[p + f], got[f], f"{name} step {t} {f}")
        if up:
            np.testing.assert_allclose(got["tau"], ref[p + "tau"],
                                       rtol=RTOL, atol=ATOL)
        else:
            assert_bitwise(ref[p + "tau"], got["tau"], f"{name} tau")
    # every position's slab of one column block is the same tensor value
    first = st.tau[0]
    for p, s in enumerate(collectives.axis_index("model", mesh)):
        if s == 0:
            assert_bitwise(first, st.tau[p], "replicated slab")


def test_run_sharded_colony_equals_reference(ref):
    """run_sharded_colony (plain route) over a (1, 4) mesh, three
    iterations, bitwise; its state round-trips through the converters."""
    mesh = _mesh((1, 4), ("data", "model"))
    inst = ttsp.random_instance(SC_N, seed=7)
    st = islands.run_sharded_colony(inst, taco.ACOConfig(rho=0.1, seed=5),
                                    mesh, iterations=3)
    got = convert.sharded_state_to_numpy(st, mesh)
    for f in ("tau", "best_tour", "best_len", "iteration", "key"):
        assert_bitwise(ref[f"run_sc_{f}"], got[f], f)
    back = convert.sharded_state_from_numpy(mesh=mesh, **{
        f: ref[f"run_sc_{f}"] for f in got})
    for a, b in zip(back.tau, st.tau):
        assert_bitwise(a, b, "slab")
    assert ttsp.is_valid_tour(st.best_tour.numpy())


def test_sharded_colony_rejections():
    mesh = _mesh((1, 5), ("data", "model"))
    inst = ttsp.random_instance(24, seed=0)
    with pytest.raises(ValueError, match="must divide"):
        islands.init_sharded_colony(inst, taco.ACOConfig(), mesh)
    with pytest.raises(tops.UnsupportedKernelRoute, match="quantised"):
        islands.run_sharded_colony(inst, taco.ACOConfig(tau_dtype="bf16"),
                                   _mesh((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="ants"):
        islands.sharded_colony_step_fn(_mesh((2, 4), ("data", "model")), 24,
                                       taco.ACOConfig(m=5), "model",
                                       ants_axis="data")


# ------------------------------------------------- checkpoint resharding
@pytest.mark.parametrize("n_new", [2, 4, 6])
def test_reshard_islands_equals_reference(ref, n_new):
    """Shrink keeps the best islands in argsort order (ties included);
    grow tiles round-robin with keys fold_in(key, i): bitwise."""
    inst = ttsp.circle_instance(24, seed=1)
    st = islands.init_island_states(inst, islands.IslandConfig(), 4,
                                    device="cpu")
    st = st._replace(best_len=torch.tensor([3.0, 1.0, 2.0, 1.0]))
    got = tck.reshard_islands(st, n_new)
    for f in taco.ColonyState._fields:
        want = ref[f"reshard{n_new}_{f}"]
        g = getattr(got, f)
        if f == "key":
            g = g.numpy().astype(np.uint32)
        assert_bitwise(want, g, f"reshard {n_new} {f}")
    if n_new > 4:
        assert len({tuple(k) for k in got.key.tolist()}) == n_new


def test_restore_to_sharding_targets(tmp_path):
    """One device for every leaf, one per leaf, or one row per position:
    each restores the saved values bitwise where it was asked to."""
    inst = ttsp.circle_instance(24, seed=1)
    st = islands.init_island_states(inst, islands.IslandConfig(), 3,
                                    device="cpu")
    st = st._replace(key=torch.stack([sampling.prng_key(40 + i)
                                      for i in range(3)]))
    path = str(tmp_path / "c.npz")
    tck.save_pytree(path, st)
    whole = tck.restore_to_sharding(path, st, "cpu")
    per_leaf = tck.restore_to_sharding(
        path, st, taco.ColonyState(*([CPU] * 5)))
    for a, b, c in zip(tree.flatten(st), tree.flatten(whole),
                       tree.flatten(per_leaf)):
        assert_bitwise(a, b, "whole")
        assert_bitwise(a, c, "per leaf")
    rows = tck.restore_to_sharding(path, st, [CPU] * 3)
    assert len(rows) == 3
    for i, row in enumerate(rows):
        for a, b in zip(tree.flatten(tree.index(st, i)), tree.flatten(row)):
            assert_bitwise(a, b, f"row {i}")
    with pytest.raises(ValueError, match="shardings"):
        tck.restore_to_sharding(path, st, (CPU, CPU))


# ---------------------------------------------------- gradient compression
@pytest.mark.parametrize("tag", ["nokey", "key"])
def test_compress_grads_equals_reference(ref, tag):
    """Two error-feedback steps over a dict of gradients, round-to-nearest
    and stochastic (leaf i drawing from fold_in(key, i), keys sorted as
    jax.tree does): int8 payloads, scales, residuals and the decompressed
    values bitwise."""
    grads = {"w": torch.from_numpy(ref["grads_w"]),
             "b": torch.from_numpy(ref["grads_b"])}
    key = None if tag == "nokey" else sampling.prng_key(3)
    state = None
    for t in range(2):
        q, s, state = compression.compress_grads(grads, state, key)
        back = compression.decompress_grads(q, s)
        assert list(q) == sorted(grads)
        for k in grads:
            p = f"comp_{tag}{t}_"
            assert q[k].dtype == torch.int8
            assert_bitwise(ref[p + "q_" + k], q[k], f"{t} q {k}")
            assert_bitwise(ref[p + "s_" + k], s[k], f"{t} scale {k}")
            assert_bitwise(ref[p + "err_" + k], state.error[k], f"{t} err")
            assert_bitwise(ref[p + "back_" + k], back[k], f"{t} back {k}")
    init = compression.compression_init(grads)
    assert all(float(e.abs().max()) == 0.0 for e in init.error.values())
    bf = compression.dequantize_int8(q["w"], s["w"], torch.bfloat16)
    assert bf.dtype == torch.bfloat16
