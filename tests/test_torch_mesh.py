"""Multi-device placement: meshes, the sharded engine, both services and
the CLI's ``--shard``, against the reference and against the port's own
single-device calls.

The reference's sharded ``run_batch`` and ``solve_instances(mesh=)`` run
once per module in a subprocess over eight forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), which writes an
``.npz``; the port runs the same batches on an 8-position mesh of
``cpu``.  Per instance: tours, lengths, iterations and keys bitwise.  Tau
against the reference's single-device run: bitwise, AS at rho 0.1 on the
kernel route at rtol 1e-5 / atol 1e-7 (the reference's one-step Pallas
update fuses evaporation into the deposit).  Against the reference's own
8-device run tau is bitwise on the pure route and at rtol 1e-5 / atol
1e-7 on the kernel route: there the reference's one-slot shards compile
its Pallas update differently from its single-device program (MMAS at
rho 0.1: 30 of 1280 cells, an ulp; ACS over int8: 8 of 80 row scales),
so its sharded run is not bitwise its unsharded one.  The port's sharded
calls are bitwise its unsharded ones in every field, for D = 1, 3, 8
(B = 5: 5 % 3 and 5 % 8 uneven) and with ``donate``.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, tree  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import solve_serve as tserve  # noqa: E402
from repro_torch.solver import (SolverService,  # noqa: E402
                                 StreamingSolverService)
from repro_torch.solver import batch as tbatch  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import placement  # noqa: E402

from torch_parity import assert_bitwise  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-7)
NS = (10, 13, 12, 15, 11)
BUDGETS = [6, 3, 5, 2, 7]
SEEDS = [40 + i for i in range(5)]
# name -> ACOConfig kwargs (iterations 7, patience 3 in every run)
CASES = {
    "as_kernel": dict(variant="as", rho=0.1, use_pallas=True),
    "mmas_kernel": dict(variant="mmas", rho=0.1, use_pallas=True),
    "mmas_pure": dict(variant="mmas", rho=0.1),
    "acs_kernel_int8": dict(variant="acs", use_pallas=True, tau_dtype="int8"),
}
LOOSE = {"as_kernel"}

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import aco, tsp
from repro.solver import batch as bm, engine, placement
NS, BUDGETS, SEEDS, CASES = eval(sys.argv[2])
assert len(jax.devices()) == 8
insts = [tsp.circle_instance(n, seed=n) if k % 2 == 0
         else tsp.random_instance(n, seed=n) for k, n in enumerate(NS)]
out = {}
for name, kw in CASES.items():
    cfg = aco.ACOConfig(iterations=7, **kw)
    b = bm.make_batch(insts, 16, cfg.nn_k)
    for tag, mesh in (("8", placement.data_mesh(8)), ("1", None)):
        st, since = engine.run_batch(
            b.problem, engine.init_states(insts, cfg, SEEDS, 16),
            jnp.asarray(BUDGETS, jnp.int32), cfg, 7, patience=3, mesh=mesh)
        p = f"{name}{tag}_"
        for f in st._fields:
            v = getattr(st, f)
            if f == "tau" and isinstance(v, tuple):
                for g, x in zip(("q", "scale", "err"), v):
                    out[p + "tau_" + g] = np.asarray(x)
            else:
                out[p + f] = np.asarray(v)
        out[p + "since"] = np.asarray(since)
cfg = aco.ACOConfig(variant="mmas", use_pallas=True, iterations=4)
st, _ = engine.solve_instances(insts, cfg, iterations=BUDGETS,
                               mesh=placement.data_mesh(8))
for f in st._fields:
    out[f"solve_{f}"] = np.asarray(getattr(st, f))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), path,
         repr((NS, BUDGETS, SEEDS, CASES))],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _insts():
    return [ttsp.circle_instance(n, seed=n) if k % 2 == 0
            else ttsp.random_instance(n, seed=n) for k, n in enumerate(NS)]


def cpu_mesh(d, axis="data"):
    return tmesh.Mesh([CPU] * d, (axis,))


def _run(cfg, mesh=None, donate=False, metrics_rows=None):
    insts = _insts()
    b = tbatch.make_batch(insts, 16, cfg.nn_k, device="cpu")
    st = teng.init_states(insts, cfg, SEEDS, 16, device="cpu")
    return teng.run_batch(b.problem, st, BUDGETS, cfg, 7, patience=3,
                          mesh=mesh, donate=donate, mets=metrics_rows)


def _leaves_bitwise(a, b, what):
    la, lb = tree.flatten(a), tree.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert_bitwise(x, y, what)


# ------------------------------------------------------------------ mesh
def test_mesh_shapes_and_device_lists():
    """Named axes over repeated devices; data_mesh past the cards there
    are fails with the reference's message; submesh and make_mesh_for
    factor as the reference does."""
    m = tmesh.Mesh([CPU] * 4, ("data",))
    assert m.shape == {"data": 4} and m.size == 4
    assert m.device_list() == [CPU] * 4
    m2 = tmesh.make_mesh_for(["cpu"] * 8, model_parallel=4)
    assert m2.shape == {"data": 2, "model": 4}
    assert m2.submesh(("model",)).shape == {"model": 4}
    assert m2.submesh(("model", "data")).shape == {"model": 4, "data": 2}
    assert tmesh.make_mesh_for(["cpu"] * 8, 2, pods=2).shape == {
        "pod": 2, "data": 2, "model": 2}
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=f"requested {n_cards + 1} devices, have "
                             f"{n_cards}"):
        placement.data_mesh(n_cards + 1)
    with pytest.raises(ValueError, match="devices"):
        placement.data_mesh(0)
    assert placement.data_mesh([CPU] * 3).shape["data"] == 3
    assert placement.device_label(CPU, 2) == "dev2:cpu0"
    assert placement.device_label(None, 1) == "dev1"
    with pytest.raises(ValueError):
        tmesh.Mesh([CPU] * 4, ("data", "model"))


def test_pad_to_devices_phantom_slots():
    """Uneven batches gain replicated row-0 phantom slots with budget 0
    (host n_actual and metrics rows included); even ones pass through."""
    cfg = taco.ACOConfig(metrics=True)
    insts = _insts()[:3]
    b = tbatch.make_batch(insts, 16, cfg.nn_k, device="cpu")
    st = teng.init_states(insts, cfg, [1, 2, 3], 16, device="cpu")
    since = torch.zeros(3, dtype=torch.int32)
    from repro_torch.obs import metrics as obs_metrics
    mets = obs_metrics.zeros_batch(3, "cpu")
    p, s, bud, sn, mt, orig = placement.pad_to_devices(
        b.problem, st, [5, 6, 7], since, 4, mets)
    assert orig == 3 and bud == [5, 6, 7, 0] and sn.shape == (4,)
    assert p.n_actual == b.problem.n_actual + (b.problem.n_actual[0],)
    assert_bitwise(p.dist[3], p.dist[0], "phantom dist")
    assert_bitwise(s.tau[3], s.tau[0], "phantom tau")
    assert mt.best_len.shape == (4,)
    p2, s2, bud2, _, _, orig2 = placement.pad_to_devices(
        b.problem, st, [5, 6, 7], since, 3)
    assert p2 is b.problem and s2 is st and bud2 == [5, 6, 7]


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_run_batch_equals_reference_8dev(ref, name):
    """The port's run_batch over an 8-position cpu mesh against the
    reference's over eight devices and over one, per instance."""
    cfg = taco.ACOConfig(iterations=7, **CASES[name])
    st, since = _run(cfg, cpu_mesh(8))
    got = convert.states_to_numpy(st)
    taus = got["tau"] if isinstance(got["tau"], tuple) else (got["tau"],)
    for tag in ("8", "1"):
        p = f"{name}{tag}_"
        for f in ("best_tour", "best_len", "iteration", "key", "since"):
            assert_bitwise(ref[p + f], since if f == "since" else got[f],
                           f"{name} D={tag} {f}")
        keys = ["tau_q", "tau_scale", "tau_err"] if len(taus) == 3 \
            else ["tau"]
        exact = name not in LOOSE if tag == "1" else not cfg.use_pallas
        for k, x in zip(keys, taus):
            if exact or x.dtype.kind != "f":
                assert_bitwise(ref[p + k], x, f"{name} D={tag} {k}")
            else:
                np.testing.assert_allclose(x, ref[p + k], **TOL)


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("name", ["as_kernel", "acs_kernel_int8",
                                  "mmas_pure"])
def test_sharded_run_batch_equals_unsharded(name, d, donate):
    """Sharded == the port's single-device run_batch in every leaf, for
    D = 1, 3, 8 (uneven B % D), donated or not; donate updates the
    caller's stack in place."""
    cfg = taco.ACOConfig(iterations=7, **CASES[name])
    want = _run(cfg)
    insts = _insts()
    b = tbatch.make_batch(insts, 16, cfg.nn_k, device="cpu")
    st = teng.init_states(insts, cfg, SEEDS, 16, device="cpu")
    before = tree.map(torch.clone, st)
    got = teng.run_batch(b.problem, st, BUDGETS, cfg, 7, patience=3,
                         mesh=cpu_mesh(d), donate=donate)
    _leaves_bitwise(want, got, f"{name} D={d} donate={donate}")
    if donate:
        assert got[0].best_len is st.best_len
    else:
        _leaves_bitwise(before, st, "inputs untouched")


def test_sharded_metrics_rows_and_instance_spec():
    """Metrics rows shard and come back bitwise; a 2-D mesh shards over
    the named axis; an unknown axis and a sparse batch are refused."""
    cfg = taco.ACOConfig(iterations=7, variant="mmas", use_pallas=True,
                         metrics=True)
    want = _run(cfg)
    m2 = tmesh.Mesh(np.array([CPU] * 6, dtype=object).reshape(2, 3),
                    ("data", "model"))
    for mesh, spec in ((cpu_mesh(4), "data"), (m2, "model")):
        insts = _insts()
        b = tbatch.make_batch(insts, 16, cfg.nn_k, device="cpu")
        st = teng.init_states(insts, cfg, SEEDS, 16, device="cpu")
        got = teng.run_batch(b.problem, st, BUDGETS, cfg, 7, patience=3,
                             mesh=mesh, instance_spec=spec)
        assert len(got) == 3
        _leaves_bitwise(want, got, f"metrics over {spec}")
    with pytest.raises(ValueError, match="no axis"):
        _run(cfg, tmesh.Mesh([CPU], ("model",)))
    scfg = taco.ACOConfig(sparse=True, sparse_k=6, iterations=2)
    with pytest.raises(tops.UnsupportedKernelRoute, match="mesh sharding"):
        teng.solve_instances(_insts(), scfg, mesh=cpu_mesh(2), device="cpu")


def test_solve_instances_mesh_equals_reference(ref):
    """solve_instances(mesh=) over eight cpu positions against the
    reference's over eight devices, and against the port unsharded; with
    no device given the batch lives on the mesh's first position."""
    cfg = taco.ACOConfig(variant="mmas", use_pallas=True, iterations=4)
    st, b = teng.solve_instances(_insts(), cfg, iterations=BUDGETS,
                                 mesh=cpu_mesh(8))
    assert st.tau.device == CPU
    got = convert.states_to_numpy(st)
    for f in ("tau", "best_tour", "best_len", "iteration", "key"):
        assert_bitwise(ref[f"solve_{f}"], got[f], f)
    plain, _ = teng.solve_instances(_insts(), cfg, iterations=BUDGETS,
                                    device="cpu")
    _leaves_bitwise(plain, st, "unsharded")
    rows = teng.collect(st, b)
    assert all(ttsp.is_valid_tour(r["best_tour"]) for r in rows)


# -------------------------------------------------------------- services
def test_service_mesh_equals_unsharded():
    """SolverService over a mesh returns bitwise the unsharded service's
    results (several buckets, uneven counts per bucket), with and without
    checkpointed chunks; stats and health report the positions."""
    insts = [ttsp.circle_instance(n, seed=n)
             for n in (10, 14, 12, 20, 26, 11, 24)]
    cfg = taco.ACOConfig(iterations=5, variant="mmas", use_pallas=True)

    def run(mesh, **kw):
        svc = SolverService(cfg, max_batch=4, mesh=mesh, **kw)
        for k, inst in enumerate(insts):
            svc.submit(inst, iterations=3 + (k % 3), seed=60 + k)
        return svc.run(), svc

    want, _ = run(None, device="cpu")
    for mesh, kw in ((cpu_mesh(8), {}), (cpu_mesh(3), {})):
        got, svc = run(mesh, **kw)
        assert svc.stats["devices"] == mesh.size
        assert svc.health()["devices"] == mesh.size
        for a, c in zip(want, got):
            assert a.request_id == c.request_id
            assert a.best_len == c.best_len, a.request_id
            np.testing.assert_array_equal(a.best_tour, c.best_tour)
            assert a.iterations == c.iterations


def test_service_mesh_checkpointed_equals_plain(tmp_path):
    insts = [ttsp.random_instance(n, seed=n) for n in (10, 14, 12)]
    cfg = taco.ACOConfig(iterations=5, variant="mmas", use_pallas=True,
                         metrics=True)
    out = []
    for kw in (dict(device="cpu"),
               dict(mesh=cpu_mesh(2), checkpoint_dir=str(tmp_path),
                    ckpt_chunk=2)):
        svc = SolverService(cfg, max_batch=4, patience=2, **kw)
        for k, inst in enumerate(insts):
            svc.submit(inst, seed=k)
        out.append(svc.run())
    for a, c in zip(*out):
        assert a.best_len == c.best_len and a.iterations == c.iterations
        np.testing.assert_array_equal(a.best_tour, c.best_tour)
        assert a.metrics == c.metrics
    with pytest.raises(tops.UnsupportedKernelRoute, match="mesh sharding"):
        SolverService(taco.ACOConfig(sparse=True), mesh=cpu_mesh(2))


def test_streaming_per_position_pools_match_single_pool():
    """StreamingSolverService with one pool per mesh position returns
    bitwise the single-pool results on the same admission order and
    spreads the first wave over the pools."""
    insts = [ttsp.circle_instance(n, seed=n) if k % 2 == 0
             else ttsp.random_instance(n, seed=n)
             for k, n in enumerate((10, 13, 12, 14, 11, 15, 16, 13))]
    buds = (6, 3, 7, 4, 5, 6, 2, 4)
    cfg = taco.ACOConfig(iterations=8, variant="mmas", use_pallas=True)

    def run(mesh, **kw):
        svc = StreamingSolverService(cfg, max_batch=2, min_bucket=16,
                                     chunk=2, mesh=mesh, **kw)
        for k, inst in enumerate(insts):
            svc.submit(inst, iterations=buds[k], seed=80 + k)
        return ({r.request_id: r for r in svc.run_until_drained()},
                svc)

    want, _ = run(None, device="cpu")
    got, svc = run(cpu_mesh(4))
    stats = svc.stats
    assert stats["devices"] == 4 and stats["pools"] == 4, stats
    assert stats["fills"] == len(insts)
    labels = {p["device"] for p in svc.health()["pools"]}
    assert labels == {f"dev{j}:cpu0" for j in range(4)}
    for k in want:
        assert want[k].best_len == got[k].best_len, k
        np.testing.assert_array_equal(want[k].best_tour, got[k].best_tour)
        assert want[k].iterations == got[k].iterations


# ------------------------------------------------------------------- CLI
BASE = ["--variant", "mmas", "--num-instances", "5", "--min-n", "12",
        "--max-n", "40", "--iterations", "5", "--max-batch", "2",
        "--use-pallas", "--device", "cpu"]


def _cli(argv, capsys, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["solve_serve"] + argv)
    tserve.main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("mode", [[], ["--stream", "--arrival-rate", "20",
                                       "--chunk", "2"]],
                         ids=["drain", "stream"])
def test_cli_shard_reports_equal_unsharded(mode, capsys, monkeypatch):
    """``--shard --devices 4 --device cpu`` reports, request by request,
    what the unsharded CLI reports; the stats count the positions."""
    want = _cli(BASE + mode, capsys, monkeypatch)
    got = _cli(BASE + mode + ["--shard", "--devices", "4"], capsys,
               monkeypatch)
    assert got["stats"]["devices"] == 4
    assert set(got) == set(want)
    for g, w in zip(got["results"], want["results"]):
        for f in ("id", "name", "n", "bucket", "best_len", "iterations",
                  "gap_pct"):
            assert g[f] == w[f], (f, g[f], w[f])


def test_cli_sparse_shard_gives_reference_rejection(capsys, monkeypatch):
    """``--sparse --shard`` exits 2 with the route checker's one line,
    the reference's own message."""
    from repro.kernels import ops as jops
    with pytest.raises(jops.UnsupportedKernelRoute) as want:
        jops.check_kernel_route(sparse=True, mesh=True)
    monkeypatch.setattr(sys, "argv", ["solve_serve", "--sparse", "--shard",
                                      "--devices", "2"] + BASE)
    with pytest.raises(SystemExit) as exc:
        tserve.main()
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.strip() == f"solve_serve: {want.value}"
