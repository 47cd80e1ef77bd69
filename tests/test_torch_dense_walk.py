"""Port parity for the dense fused walk (``kernels/fused_select.py``
``fused_walk``: the dense kernel route's whole construction in one launch).

- ``fused_walk_plain`` (the host loop of plain steps: ``fold_in``, the
  step's full draw, ``fused_select_plain``, tabu update) on the CPU
  against the reference's ``construct_tours(method="fused")`` (the Pallas
  kernel in interpret mode): float32, int8 and bf16 payloads, packed and
  counter draws, unpadded and padded instances.  Tours and lengths bitwise
  for iroulette and greedy; for gumbel (``torch.log`` is an ulp off XLA's
  ``log``) the tours agree up to the first step where the reference's
  scores of the two picks lie within 4 ulp, and every tour is valid.
- A plain-torch emulation of the kernel's step (the step key
  ``threefry(kc, (0, t))``, the draw hashed with ``draw_at_plain`` only
  where it can change the score: iroulette where ``keep and w != 0``,
  gumbel where ``keep and w > 0``, greedy nowhere) is bitwise the plain
  walk in every mode, payload and draw, on padded instances, from a
  mid-walk state, and where an ant's unvisited cities all weigh 0 (the
  lowest-index pick then falls on a visited city, as in the reference).
- ``ops.fused_walk`` on CPU tensors is the host loop, and
  ``construct_tours(method="fused")`` is its tours; no kernel launches.
- The launchers refuse CPU tensors, wrong dtypes, shapes and options.
The kernel against the plain walk on the card is in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core import strategies as jstr  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro_torch.core import quant, sampling, strategies  # noqa: E402
from repro_torch.core import tsp as ttsp  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_select as ss  # noqa: E402
from repro_torch.kernels.choice_info import ipow  # noqa: E402
from repro_torch.kernels.tour_select import transform  # noqa: E402
from torch_parity import OnCard, assert_bitwise, jax_scores  # noqa: E402
from torch_parity import ulp_distance  # noqa: E402

MODES = ["iroulette", "greedy", "gumbel"]
PAYLOADS = ["fp32", "int8", "bf16"]


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _operands(n, n_actual, tau_dtype, seed):
    """The reference's and the port's (dist, eta, tau payload, scale) of
    one instance: random_instance (padded to n when n_actual is set), a
    seeded tau, stochastically quantised by the reference."""
    if n_actual is None:
        inst = jtsp.random_instance(n, seed=seed)
    else:
        inst = jtsp.pad_instance(jtsp.random_instance(n_actual, seed=seed), n)
    prob = jaco.make_problem(inst, 8)
    rng = np.random.default_rng(seed)
    tau = jnp.asarray((rng.random((n, n)) * 1e-2 + 1e-3).astype(np.float32))
    scale_j = None
    if tau_dtype != "fp32":
        qt = jq.quantise(tau, tau_dtype, key=jax.random.PRNGKey(seed))
        tau = qt.q
        scale_j = qt.scale if tau_dtype == "int8" else None
    t_tau = torch.from_numpy(_bits(tau).copy())
    if tau_dtype == "bf16":
        t_tau = t_tau.view(torch.bfloat16)
    port = (torch.tensor(np.asarray(prob.dist)),
            torch.tensor(np.asarray(prob.eta)), t_tau,
            None if scale_j is None else torch.tensor(np.asarray(scale_j)))
    return (prob.dist, prob.eta, tau, scale_j), port


def _port_walk(port, key_seed, m, n_actual, mode, draw_mode):
    """(start, kc, steps) of the port's plain walk under construct_tours'
    keys."""
    dist, eta, tau, scale = port
    kp, kc = sampling.split(sampling.prng_key(key_seed))
    start = strategies.place_ants(kp, m, dist.shape[0], n_actual)
    steps = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, n_actual,
                                mode, draw_mode, scale)
    return start, kc, steps


def _assert_gumbel_tours(want, got, kc, port, n_actual, draw_mode):
    """Tours agree up to each ant's first differing step; there the
    reference's scores of the two picks lie within 4 ulp."""
    want, got = np.asarray(want), got.numpy()
    dist, eta, tau, scale = port
    n = want.shape[1]
    w_full = (quant.dequantise_rows(tau, scale) * (eta * eta)).numpy()
    for a in np.nonzero((want != got).any(axis=1))[0]:
        t = int(np.argmax(want[a] != got[a]))
        key = sampling.fold_in(kc, t)
        u = strategies._draw_step_uniform(key, (want.shape[0], n),
                                          draw_mode)[a].numpy()
        visited = np.zeros(n, bool)
        visited[want[a, :t]] = True
        scores = jax_scores(w_full[want[a, t - 1]][None], visited[None],
                            u[None], n_actual, "gumbel")[0]
        d = ulp_distance(scores[want[a, t]], scores[got[a, t]])
        assert d <= 4, (a, t, d)
    real = n if n_actual is None else n_actual
    for tour in got:
        assert ttsp.is_valid_tour(tour[:real])


# (mode, payload, draw, n_actual) on n = 32 (padded: 27 real of 32)
REFERENCE_CASES = (
    [(mode, p, "packed", None) for mode in MODES for p in PAYLOADS]
    + [("iroulette", p, "counter", None) for p in PAYLOADS]
    + [("gumbel", "fp32", "counter", None)]
    + [("iroulette", p, "packed", 27) for p in PAYLOADS]
    + [("greedy", "int8", "counter", 27), ("gumbel", "bf16", "packed", 27)])


@pytest.mark.parametrize("mode,tau_dtype,draw_mode,n_actual", REFERENCE_CASES)
def test_plain_walk_is_the_reference_fused_construction(mode, tau_dtype,
                                                        draw_mode, n_actual):
    n, m, seed = 32, 9, 4
    (j_dist, j_eta, j_tau, j_scale), port = _operands(n, n_actual, tau_dtype,
                                                      seed)
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jstr.construct_tours(
        jax.random.PRNGKey(seed), j_dist, jnp.zeros((1, 1), jnp.float32), m,
        method="fused", selection=mode, tau=j_tau, eta=j_eta, alpha=1.0,
        beta=2.0, n_actual=na, tau_scale=j_scale, draw_mode=draw_mode)
    start, kc, steps = _port_walk(port, seed, m, n_actual, mode, draw_mode)
    tours = torch.cat([start[None], steps]).T.contiguous()
    assert steps.shape == (n - 1, m) and steps.dtype == torch.int32
    if mode == "gumbel":
        _assert_gumbel_tours(want.tours, tours, kc, port, n_actual,
                             draw_mode)
        return
    assert_bitwise(want.tours, tours, "tours")
    assert_bitwise(want.lengths, ttsp.tour_length(port[0], tours, n_actual),
                   "lengths")


# ------------------------------------------------- the kernel's step

def step_key(kc: torch.Tensor, t: int) -> torch.Tensor:
    """The kernel's step key: threefry(kc, (0, t))."""
    y0, y1 = sampling.threefry2x32(kc[0], kc[1],
                                   torch.zeros(1, dtype=torch.int64),
                                   torch.tensor([t]))
    return torch.cat([y0, y1])


def needs_draw(w, keep, mode):
    """Where the draw can change a city's score."""
    if mode == "iroulette":
        return keep & (w != 0)
    if mode == "gumbel":
        return keep & (w > 0)
    return torch.zeros_like(keep)


def walk_emulation(tau, eta, start, kc, n_actual, mode, draw_mode,
                   tau_scale=None, visited=None, first_step=1):
    """The kernel's walk in plain torch: one step key per step, the draw
    hashed at the cities that need it only (u = 1 elsewhere), every city's
    transformed score, the lowest-index arg-max."""
    m, n = start.shape[0], tau.shape[1]
    n_act = n if n_actual is None else n_actual
    tau_f = quant.dequantise_rows(tau, tau_scale)
    ants, cols = torch.arange(m), torch.arange(n)
    vis = torch.zeros((m, n), dtype=torch.bool) if visited is None \
        else visited.clone()
    vis[ants, start.long()] = True
    cur, out = start.long(), []
    for t in range(first_step, n):
        if t >= n_act:
            nxt = torch.full((m,), t)
        else:
            w = ipow(tau_f[cur], 1.0) * ipow(eta[cur], 2.0)
            keep = ~vis & (cols < n_act)
            need = needs_draw(w, keep, mode)
            u = torch.ones((m, n))
            a_idx, c_idx = need.nonzero(as_tuple=True)
            u[a_idx, c_idx] = ss.draw_at_plain(step_key(kc, t), a_idx, c_idx,
                                               n, draw_mode)
            nxt = torch.argmax(transform(w, keep.float(), u, mode), dim=-1)
        vis[ants, nxt] = True
        out.append(nxt.to(torch.int32))
        cur = nxt
    return torch.stack(out)


def _port_operands(n, m, tau_dtype, seed, n_actual=None):
    _, (dist, eta, tau, scale) = _operands(n, n_actual, tau_dtype, seed)
    gen = torch.Generator().manual_seed(seed)
    start = torch.randint(0, n_actual or n, (m,), generator=gen,
                          dtype=torch.int32)
    kc = sampling.split(sampling.prng_key(seed))[1]
    return tau, scale, eta, start, kc


@pytest.mark.parametrize("draw_mode", ["packed", "counter"])
@pytest.mark.parametrize("tau_dtype", PAYLOADS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_step_emulation_is_the_plain_walk(mode, tau_dtype, draw_mode):
    tau, scale, eta, start, kc = _port_operands(37, 11, tau_dtype, 2)
    want = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, None, mode,
                               draw_mode, scale)
    got = walk_emulation(tau, eta, start, kc, None, mode, draw_mode, scale)
    assert_bitwise(want, got, f"{mode} {tau_dtype} {draw_mode}")


@pytest.mark.parametrize("tau_dtype", PAYLOADS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_step_emulation_padded_and_mid_walk(mode, tau_dtype):
    """A padded instance (31 real cities of 38), and the walk's last 9
    steps from a random mid-walk state (every city visited but about 9)."""
    tau, scale, eta, start, kc = _port_operands(38, 7, tau_dtype, 5, 31)
    want = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, 31, mode,
                               "packed", scale)
    got = walk_emulation(tau, eta, start, kc, 31, mode, "packed", scale)
    assert_bitwise(want, got, "padded")
    gen = torch.Generator().manual_seed(9)
    visited = torch.rand((7, 38), generator=gen) < 0.75
    want = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, None, mode,
                               "counter", scale, visited, 29)
    got = walk_emulation(tau, eta, start, kc, None, mode, "counter", scale,
                         visited, 29)
    assert want.shape == (9, 7)
    assert_bitwise(want, got, "mid-walk")


@pytest.mark.parametrize("tau_dtype", PAYLOADS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_step_emulation_all_zero_weights(mode, tau_dtype):
    """Ant 0 stands on city 0, whose eta row is all 0: every unvisited
    city weighs 0.  Iroulette and gumbel then pick the lowest index over
    all cities, visited or not (city 0 again), greedy the lowest unvisited
    one; the emulation and the plain walk agree."""
    tau, scale, eta, start, kc = _port_operands(24, 6, tau_dtype, 3)
    eta = eta.clone()
    eta[0] = 0.0
    start = start.clone()
    start[0] = 0
    want = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, None, mode,
                               "packed", scale)
    got = walk_emulation(tau, eta, start, kc, None, mode, "packed", scale)
    assert_bitwise(want, got, "all-zero row")
    assert int(want[0, 0]) == (1 if mode == "greedy" else 0)


@pytest.mark.parametrize("mode", MODES)
def test_int8_zero_row_step_is_the_reference_kernel(mode):
    """An int8 store whose payload is zero over every unvisited city of
    the current rows (the state that makes a walk emit a city twice):
    the reference's ``fused_select`` (Pallas, interpret mode) and the
    port's plain walk pick the same cities.  Every unvisited weight is
    0, so iroulette picks the first column, which is visited here: the
    reference repeats the city as the port does."""
    from repro.kernels import ops as jops
    n, m, t = 32, 5, 9
    (_, j_eta, j_tau, j_scale), (_, eta, _, _) = _operands(n, None, "int8",
                                                          4)
    rng = np.random.default_rng(4)
    visited = np.zeros((m, n), bool)
    for a in range(m):
        visited[a, rng.choice(np.arange(1, n), t - 1, replace=False)] = True
    visited[:, 0] = True
    cur = np.array([np.nonzero(v)[0][-1] for v in visited], np.int32)
    q = np.asarray(j_tau).copy()
    for a in range(m):
        q[cur[a], ~visited[a]] = 0          # the row is zero where it counts
    kc = sampling.split(sampling.prng_key(4))[1]
    u = strategies._draw_step_uniform(sampling.fold_in(kc, t), (m, n),
                                      "packed")
    want = jops.fused_select(jnp.asarray(q), j_eta, jnp.asarray(cur),
                             jnp.asarray(visited), jnp.asarray(u.numpy()),
                             1.0, 2.0, None, mode, tau_scale=j_scale)
    got = fs.fused_walk_plain(torch.from_numpy(q), eta, torch.from_numpy(cur),
                              kc, 1.0, 2.0, None, mode, "packed",
                              torch.tensor(np.asarray(j_scale)),
                              visited=torch.from_numpy(visited),
                              first_step=t)[0]
    assert_bitwise(want, got, f"{mode} pick")
    if mode == "iroulette":
        assert (got.numpy() == 0).all()     # city 0 again, on both sides


# ------------------------------------------------- the dispatch on the CPU

@pytest.mark.parametrize("tau_dtype", PAYLOADS)
def test_ops_fused_walk_on_cpu_is_the_host_loop(tau_dtype):
    tau, scale, eta, start, kc = _port_operands(30, 8, tau_dtype, 6, 26)
    ops.reset_launch_counts()
    got = ops.fused_walk(tau, eta, start, kc, 1.0, 2.0, 26, "iroulette",
                         "counter", tau_scale=scale)
    want = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, 26,
                               "iroulette", "counter", scale)
    assert torch.equal(got, want)
    dist = torch.rand(30, 30)
    key = sampling.prng_key(6)
    res = strategies.construct_tours(key, dist, None, 8, method="fused",
                                     tau=tau, eta=eta, n_actual=26,
                                     draw_mode="counter", tau_scale=scale)
    kp, kc = sampling.split(key)
    start = strategies.place_ants(kp, 8, 30, 26)
    steps = fs.fused_walk_plain(tau, eta, start, kc, 1.0, 2.0, 26,
                                "iroulette", "counter", scale)
    assert torch.equal(res.tours, torch.cat([start[None], steps]).T)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_walk_launchers_refuse_cpu_tensors_and_bad_inputs():
    """No fallback: CPU tensors are refused, and so are wrong dtypes,
    shapes, alignments and options, before any launch."""
    tau, scale, eta, start, kc = _port_operands(20, 4, "int8", 1)
    tau_f = quant.dequantise_rows(tau, scale)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_walk(tau_f, eta, start, kc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_walk_quant(tau, scale, eta, start, kc)
    C = OnCard
    ok = dict(tau=C(tau_f), eta=C(eta), start=C(start), key=C(kc))
    odd = torch.rand(20 * 20 + 1)[1:].view(20, 20)    # 4 bytes off 16
    for bad, err, match in (
            (dict(tau=C(tau_f.double())), TypeError, "float32"),
            (dict(eta=C(eta[:, :19].contiguous())), ValueError, "shape"),
            (dict(start=C(start.long())), TypeError, "int32"),
            (dict(key=C(kc[:1].contiguous())), ValueError, "shape"),
            (dict(visited=C(torch.zeros(4, 20, dtype=torch.uint8))),
             TypeError, "bool"),
            (dict(tau=C(odd)), ValueError, "aligned"),
            (dict(mode="roulette"), ValueError, "roulette"),
            (dict(draw_mode="stream"), ValueError, "draw_mode"),
            (dict(first_step=0), ValueError, "first_step")):
        kw = {**ok, **bad}
        with pytest.raises(err, match=match):
            fs.fused_walk(kw.pop("tau"), kw.pop("eta"), kw.pop("start"),
                          kw.pop("key"), **kw)
    with pytest.raises(TypeError, match="int8"):
        fs.fused_walk_quant(C(tau_f), None, C(eta), C(start), C(kc))
    with pytest.raises(ValueError, match="scale"):
        fs.fused_walk_quant(C(tau), None, C(eta), C(start), C(kc))
    with pytest.raises(ValueError, match="shape"):
        fs.fused_walk_quant(C(tau), C(scale[:5].contiguous()), C(eta),
                            C(start), C(kc))
    assert fs.fused_walk.launches == 0 and fs.fused_walk_quant.launches == 0
