"""Port parity for the program cache (``repro_torch.solver.programs``).

Each test of tests/test_programs.py that has a counterpart holds the
port's cache to the reference's behaviour on the CPU.  This file: the
bucket ladder, ``effective_max_iters``, ``signature`` and ``mesh_label``
read as the reference's; ``check_neighbour_route`` gives the reference's
verdict and message on every configuration tested, and ``route_bucket``
its policy; the launch records of a capture; which routes a graph may
capture.  The reference's persistent XLA cache tests become tests of the
kernel build root (``enable_persistent_cache``) and
``persistent_cache_stats``.  The services with a cache are in
tests/test_torch_programs_serve.py, the card's program path (static
buffers and graphs, with a stand-in capture) in
tests/test_torch_programs_graphs.py; the helpers here serve all three.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aco as jaco  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.kernels.ops import UnsupportedKernelRoute as JUnsupported  # noqa: E402,E501
from repro.solver import batch as jbatch  # noqa: E402
from repro.solver import engine as jeng  # noqa: E402
from repro.solver import programs as jprog  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ops import UnsupportedKernelRoute  # noqa: E402
from repro_torch.solver import batch as tbatch  # noqa: E402
from repro_torch.solver import engine as teng  # noqa: E402
from repro_torch.solver import programs as tprog  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)


def _counter(**kw):
    """Neighbour-routable base config: pinned ants, width-invariant
    counter draws, no local search."""
    base = dict(iterations=4, m=4, draw_mode="counter", local_search="none",
                seed=0)
    base.update(kw)
    return base


def _same(want, got):
    """Drain or streaming results: lengths and tours bitwise."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert_bitwise(np.float32(a.best_len), np.float32(b.best_len),
                       "best_len")
        assert_bitwise(a.best_tour, b.best_tour, "best_tour")


def _drain(svc, insts, seeds, iterations=None):
    for inst, seed in zip(insts, seeds):
        svc.submit(inst, iterations=iterations, seed=seed)
    return svc.run()


# ------------------------------------------------------------ bucket ladder
def test_bucket_ladder_enumeration():
    for args in ((10, 100), (20, 20), (3, 17, 4)):
        assert tbatch.bucket_ladder(*args) == jbatch.bucket_ladder(*args)
    assert tbatch.bucket_ladder(10, 100) == [16, 32, 64, 128]
    with pytest.raises(ValueError):
        tbatch.bucket_ladder(10, 9)


def test_bucket_ladder_covers_bucket_size():
    ladder = tbatch.bucket_ladder(5, 70)
    for n in range(5, 71):
        assert tbatch.bucket_size(n) in ladder


# ------------------------------------------------------ keying / canonical
def test_effective_max_iters_canonicalisation():
    for want in (3, 8, 9):
        assert tprog.ProgramCache(iters_cap=8).effective_max_iters(want) == \
            jprog.ProgramCache(iters_cap=8).effective_max_iters(want)
    assert tprog.ProgramCache(iters_cap=8).effective_max_iters(3) == 8
    assert tprog.ProgramCache().effective_max_iters(5) == 5


def test_signature_reads_operand_shapes():
    kw = _counter()
    insts = [ttsp.circle_instance(10, seed=0)] * 2
    b = tbatch.make_batch(insts, 16, 30, device="cpu")
    states = teng.init_states(insts, taco.ACOConfig(**kw), [0, 1], 16,
                              device="cpu")
    key = tprog.ProgramCache.signature(
        b.problem, states, [0, 0], taco.ACOConfig(**kw), 4, 0, False,
        "dense", "EUC_2D")
    jinsts = [jtsp.circle_instance(10, seed=0)] * 2
    jb = jbatch.make_batch(jinsts, 16, 30)
    jstates = jeng.init_states(jinsts, jaco.ACOConfig(**kw), [0, 1], 16)
    jkey = jprog.ProgramCache.signature(
        jb.problem, jstates, np.zeros((2,), np.int32), jaco.ACOConfig(**kw),
        4, 0, False, "dense", "EUC_2D")
    for f in jprog.ProgramKey._fields:
        if f != "cfg":
            assert getattr(key, f) == getattr(jkey, f), f
    assert key.cfg == taco.ACOConfig(**kw) and key.device == "cpu"
    assert key.n_pad == 16 and key.batch == 2 and not key.hyper


def test_mesh_label():
    from repro_torch.launch.mesh import Mesh
    assert tprog.mesh_label(None) == jprog.mesh_label(None) == "-"
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object)
                .reshape(2, 2), ("data", "model"))
    assert tprog.mesh_label(mesh) == "data:2,model:2"


# --------------------------------------------------------- rejection matrix
@pytest.mark.parametrize("kw,why", [
    (dict(), "cfg.m"),
    (_counter(draw_mode="packed"), "draw_mode"),
    (_counter(local_search="2opt"), "local search"),
    (_counter(construction="nn_list"), "nn_list"),
    (_counter(sparse=True, sparse_k=8, construction="partial"),
     "Partial-ACO"),
    (_counter(tau_dtype="int8", tau_round="stochastic"), "tau_round"),
])
def test_neighbour_route_rejections(kw, why):
    with pytest.raises(JUnsupported, match=why) as want:
        jprog.check_neighbour_route(jaco.ACOConfig(**kw))
    with pytest.raises(UnsupportedKernelRoute, match=why) as got:
        tprog.check_neighbour_route(taco.ACOConfig(**kw))
    assert str(got.value) == str(want.value)
    assert not tprog.neighbour_supported(taco.ACOConfig(**kw))


@pytest.mark.parametrize("kw", [
    _counter(),
    _counter(variant="acs"),
    _counter(tau_dtype="int8", tau_round="nearest"),
    _counter(sparse=True, sparse_k=8),
])
def test_neighbour_route_accepted(kw):
    assert jprog.neighbour_supported(jaco.ACOConfig(**kw))
    tprog.check_neighbour_route(taco.ACOConfig(**kw))     # must not raise
    assert tprog.neighbour_supported(taco.ACOConfig(**kw))


def test_route_bucket_policy():
    got, want = tprog.ProgramCache(), jprog.ProgramCache()
    for pc in (got, want):
        pc._warmed_buckets[("dense", "-")] = {32, 64}
    for native, kw in ((32, _counter()), (16, _counter()), (16, {}),
                       (128, _counter())):
        assert got.route_bucket(native, taco.ACOConfig(**kw)) == \
            want.route_bucket(native, jaco.ACOConfig(**kw))
    assert got.route_bucket(16, taco.ACOConfig(**_counter())) == 32
    assert got.route_bucket(16, taco.ACOConfig()) == 16


# ---------------------------------------------------- warm / dispatch


# ------------------------------------------------- neighbour-bucket routing


# ----------------------------------------------------------- streaming svc


# ---------------------------------------------------- counter-mode draws


# ------------------------------------------------------ persistent build
def test_enable_persistent_cache_moves_the_build_root(tmp_path, monkeypatch):
    """The build root follows ``enable_persistent_cache`` before the
    library is loaded, and refuses to move once it is."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.setattr(_build, "_LIB", None)
    d = str(tmp_path / "kernels")
    got = tprog.enable_persistent_cache(d)
    assert got == os.path.abspath(d) and os.path.isdir(d)
    assert _build.lib_path().parent.parent == _build.BUILD_ROOT
    assert str(_build.BUILD_ROOT) == got
    monkeypatch.setattr(_build, "_LIB", object())      # a loaded library
    assert tprog.enable_persistent_cache(d) == got     # same root: fine
    with pytest.raises(RuntimeError, match="already loaded"):
        tprog.enable_persistent_cache(str(tmp_path / "other"))


def test_persistent_cache_stats_counts_the_build(tmp_path):
    d = tmp_path / "kernels"
    (d / "0123abcd").mkdir(parents=True)
    (d / "0123abcd" / _build.LIB_NAME).write_bytes(b"x" * 100)
    (d / "0123abcd" / "build.log").write_text("ok")
    st = tprog.persistent_cache_stats(str(d))
    assert st == {"dir": str(d), "files": 2, "bytes": 102}


def test_persistent_cache_stats_missing_dir():
    st = tprog.persistent_cache_stats("/nonexistent/aco-kernels")
    assert st["files"] == 0 and st["bytes"] == 0


def test_launches_in_a_capture_are_recorded_and_replayed():
    """A launch inside ``recording_launches`` goes to the record, not to
    the count; ``add_launches`` adds the record (a graph replay)."""
    def fake():
        pass
    fake.launches, fake.slot_launches = 5, 7
    with _build.recording_launches() as rec:
        _build.count(fake, 3)
        _build.count(fake, 2)
    assert (fake.launches, fake.slot_launches) == (5, 7)
    assert rec == {fake: [2, 5]}
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert (fake.launches, fake.slot_launches) == (9, 17)
    _build.count(fake, 1)
    assert (fake.launches, fake.slot_launches) == (10, 18)


# ----------------------------------------------- the card's program, here


def test_graph_route_keeps_host_driven_routes_eager():
    """Local search, the ``pallas`` construction, the pure route and the
    CPU stay eager."""
    insts = [ttsp.random_instance(10, seed=1)] * 2
    p = tbatch.make_batch(insts, 16, 8, device="cpu").problem
    fused = taco.ACOConfig(use_pallas=True)
    assert teng.graph_route(p, fused, "dense", "cuda")
    assert not teng.graph_route(p, fused, "dense", "cpu")
    for kw in (dict(local_search="2opt"), dict(construction="pallas"),
               dict(use_pallas=False)):
        cfg = taco.ACOConfig(**{**dict(use_pallas=True), **kw})
        assert not teng.graph_route(p, cfg, "dense", "cuda"), kw
