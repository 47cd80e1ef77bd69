"""Port parity for the whole colony: repro_torch.core.aco against repro.core.aco.

The reference's own contracts (tests/test_construction.py), across packages:

- port on the CPU vs the JAX pure route (``use_pallas=False``): tours,
  lengths, best_len, best_tour, iteration, key and tau bitwise, for AS,
  MMAS and ACS, iroulette and greedy, rho 0.5 and 0.1, unmasked and masked;
- port on the CPU vs the JAX kernel route (Pallas in interpret mode) over 3
  steps: tours and lengths bitwise; tau bitwise for MMAS and for AS with one
  ant at rho = 0.5, rtol 1e-5 / atol 1e-7 otherwise.  (When the whole
  Pallas update grid is one step, XLA inlines it and fuses the evaporation
  product into the deposit add, which the H100 kernel, like a multi-step
  Pallas grid, does not: an ulp on some cells at rho != 0.5.)
- gumbel runs: valid tours and a best length no worse than the
  nearest-neighbour tour (the ``log`` gap makes its tours not bitwise).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import sequential as jseq  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import sequential as tseq  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

INSTANCES = {
    "circle": lambda: jtsp.circle_instance(23, seed=3),
    "grid": lambda: jtsp.grid_instance(5),
    "random": lambda: jtsp.random_instance(21, seed=6),
}


def _pair(inst, kw, n_actual=None):
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jaco.make_problem(inst, cj.nn_k)
    pt = taco.make_problem(inst, ct.nn_k, device="cpu")
    if n_actual is not None:
        pj = pj._replace(n_actual=jnp.asarray(n_actual, jnp.int32))
        pt = pt._replace(n_actual=n_actual)
    return (cj, pj, jaco.init_colony(inst, cj)), \
        (ct, pt, taco.init_colony(inst, ct, device="cpu"))


def _assert_state(sj, st, tau_exact=True, what=""):
    assert_bitwise(sj.best_tour, st.best_tour, f"{what} best_tour")
    assert_bitwise(sj.best_len, st.best_len, f"{what} best_len")
    assert_bitwise(sj.iteration, st.iteration, f"{what} iteration")
    assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key, f"{what} key")
    if tau_exact:
        assert_bitwise(sj.tau, st.tau, f"{what} tau")
    else:
        np.testing.assert_allclose(np.asarray(sj.tau), st.tau.numpy(),
                                   rtol=1e-5, atol=1e-7)


def _steps(inst, kw, steps, tau_exact, n_actual=None):
    (cj, pj, sj), (ct, pt, st) = _pair(inst, kw, n_actual)
    for i in range(steps):
        sj, bj = jaco.colony_step(pj, sj, cj)
        st, bt = taco.colony_step(pt, st, ct)
        assert_bitwise(bj, bt, f"step {i} iteration-best length")
        _assert_state(sj, st, tau_exact, f"step {i}")


PURE_CASES = [(name, 0.1) for name in sorted(INSTANCES)] + [("circle", 0.5)]


@pytest.mark.parametrize("selection", ["iroulette", "greedy"])
@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
@pytest.mark.parametrize("name,rho", PURE_CASES)
def test_pure_route_bitwise(name, rho, variant, selection):
    kw = dict(variant=variant, selection=selection, rho=rho, seed=2,
              nn_k=8, iterations=3)
    _steps(INSTANCES[name](), kw, 3, tau_exact=True)


@pytest.mark.parametrize("deposit", ["scatter", "reduction"])
def test_run_and_run_scan_bitwise(deposit):
    inst = INSTANCES["random"]()
    kw = dict(variant="as", rho=0.1, seed=4, nn_k=8, iterations=4,
              deposit=deposit)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    _assert_state(jaco.run(inst, cj), taco.run(inst, ct, device="cpu"))
    pj, pt = jaco.make_problem(inst, 8), taco.make_problem(inst, 8, "cpu")
    sj, bj = jaco.run_scan(pj, jaco.init_colony(inst, cj), cj, 3)
    st, bt = taco.run_scan(pt, taco.init_colony(inst, ct, device="cpu"), ct,
                           3)
    assert_bitwise(bj, bt, "run_scan it_best")
    _assert_state(sj, st)


@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_masked_step_bitwise(variant, use_pallas):
    """A padded instance (pad_instance + n_actual) through colony_step."""
    inst = jtsp.pad_instance(jtsp.random_instance(19, seed=5), 24)
    kw = dict(variant=variant, seed=7, nn_k=8, use_pallas=use_pallas,
              rho=0.5 if use_pallas else 0.1)
    _steps(inst, kw, 2, tau_exact=variant != "as" or not use_pallas,
           n_actual=19)


@pytest.mark.parametrize("n_actual", [None, 19])
def test_mmas_clamp_at_tau_min_bitwise(n_actual):
    """Long enough for unused edges to decay to tau_min, at rho = 0.3
    (0.5 scales exactly and hides the order): the reference's compiled
    tau_min is tau_max times float32(1 / 2n), or q / (rho * (len * 2n))
    for a padded instance, not tau_max / 2n."""
    base = jtsp.random_instance(19, seed=2)
    inst = base if n_actual is None else jtsp.pad_instance(base, 24)
    kw = dict(variant="mmas", seed=2, nn_k=8, rho=0.3, m=6)
    _steps(inst, kw, 14, tau_exact=True, n_actual=n_actual)


@pytest.mark.parametrize("construction", ["data_parallel", "pallas"])
@pytest.mark.parametrize("variant,m", [("as", None), ("as", 1),
                                       ("mmas", None), ("acs", None)])
def test_kernel_route_vs_jax_kernel_route(variant, m, construction):
    kw = dict(variant=variant, m=m, construction=construction, seed=1,
              nn_k=8, use_pallas=True, rho=0.5)
    exact = variant == "mmas" or m == 1 or variant == "acs"
    _steps(INSTANCES["circle"](), kw, 3, tau_exact=exact)


@pytest.mark.parametrize("variant", ["as", "mmas"])
def test_kernel_route_rho01_ulp_close(variant):
    kw = dict(variant=variant, seed=1, nn_k=8, use_pallas=True, rho=0.1)
    _steps(INSTANCES["grid"](), kw, 3, tau_exact=False)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", ["as", "mmas", "acs"])
def test_gumbel_runs_valid_and_beat_nearest_neighbour(variant, use_pallas):
    inst = ttsp.random_instance(20, seed=1)
    cfg = taco.ACOConfig(variant=variant, selection="gumbel", iterations=15,
                         seed=3, use_pallas=use_pallas)
    st = taco.run(inst, cfg, device="cpu")
    assert ttsp.is_valid_tour(st.best_tour.numpy())
    _, c_nn = ttsp.nearest_neighbour_tour(inst.distances())
    assert float(st.best_len) <= c_nn + 1e-3
    assert torch.isfinite(st.tau).all()


def test_convert_carries_state_across():
    """A JAX colony handed over mid-run continues bitwise in the port."""
    inst = INSTANCES["circle"]()
    kw = dict(variant="mmas", rho=0.1, seed=5, nn_k=8)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jaco.make_problem(inst, 8)
    sj = jaco.init_colony(inst, cj)
    for _ in range(2):
        sj, _ = jaco.colony_step(pj, sj, cj)
    st = convert.state_from_numpy(*(np.asarray(x) for x in sj), device="cpu")
    pt = convert.problem_from_numpy(*(np.asarray(x) for x in pj[:3]),
                                    device="cpu")
    sj, _ = jaco.colony_step(pj, sj, cj)
    st, _ = taco.colony_step(pt, st, ct)
    _assert_state(sj, st)
    back = convert.state_to_numpy(st)
    assert back["key"].dtype == np.uint32
    assert_bitwise(np.asarray(sj.key), back["key"], "key round trip")
    assert set(convert.problem_to_numpy(pt)) == {"dist", "eta", "nn"}


def test_sequential_oracle_is_the_reference():
    d = jtsp.random_instance(17, seed=2).distances()
    a = jseq.SequentialAS(d, seed=4, m=6).run(3)
    b = tseq.SequentialAS(d, seed=4, m=6).run(3)
    assert a == b


@pytest.mark.parametrize("kw", [
    dict(deposit="onehot"),
    dict(construction="nn_list"),
])
def test_ladder_combinations_run_as_the_reference(kw):
    """The two configs that raised before the ladder was ported (a
    deposit and a construction) now run and equal the reference: tours,
    best and key bitwise, AS tau within rtol 1e-5 / atol 1e-7 (the
    one-hot deposit sums a cell's terms in another order)."""
    inst = jtsp.circle_instance(9)
    sj = jaco.run(inst, jaco.ACOConfig(iterations=2, **kw))
    st = taco.run(inst, taco.ACOConfig(iterations=2, **kw), device="cpu")
    _assert_state(sj, st, tau_exact=False)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kw", [dict(local_search="2opt"),
                                dict(tau_dtype="int8")])
def test_local_search_and_quantised_tau_now_run(kw, use_pallas):
    """The two options that raised before this slice ported them run on
    both routes and give a valid colony."""
    inst = ttsp.circle_instance(9)
    cfg = taco.ACOConfig(iterations=2, use_pallas=use_pallas, **kw)
    st = taco.run(inst, cfg, device="cpu")
    assert ttsp.is_valid_tour(st.best_tour.numpy())
    assert int(st.iteration) == 2
    _, c_nn = ttsp.nearest_neighbour_tour(inst.distances())
    assert float(st.best_len) <= c_nn + 1e-3


def test_hyper_raises_with_reference_message_on_kernel_route():
    inst = ttsp.circle_instance(9)
    cfg = taco.ACOConfig(use_pallas=True)
    prob = taco.make_problem(inst, 4, device="cpu")._replace(
        hyper=taco.Hyper.make(cfg, device="cpu"))
    st = taco.init_colony(inst, cfg, device="cpu")
    with pytest.raises(tops.UnsupportedKernelRoute, match="use_pallas"):
        taco.colony_step(prob, st, cfg)


def test_entry_points_need_an_explicit_cpu():
    """Without a GPU an entry point with no device raises; it never runs on
    the CPU unasked.  With a GPU it lands there."""
    inst = ttsp.circle_instance(9)
    cfg = taco.ACOConfig(iterations=1)
    if torch.cuda.is_available():
        assert taco.make_problem(inst).dist.device.type == "cuda"
        return
    for call in (lambda: taco.make_problem(inst),
                 lambda: taco.init_colony(inst, cfg),
                 lambda: taco.run(inst, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_no_jax():
    """Every module of repro_torch imports without jax or repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
