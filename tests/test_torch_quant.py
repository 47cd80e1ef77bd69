"""Port parity for the quantised pheromone store: repro_torch's
``optim.compression.quantize_int8``, ``core.quant``, the int8/bf16 payload
of ``fused_select`` and the quantised colony step against the JAX package.

Contracts:

- ``quantize_int8``, ``quantise``, ``requantise``, ``dequantise``: payload,
  scale and residual bitwise.  ``quantise`` is held to the reference's
  eager call (its ``init_colony`` path), ``requantise`` to the jitted one
  (it runs only inside the jitted colony step, where XLA multiplies by
  float32(1/127) and fuses the residual's multiply-subtract);
- the quantised ``fused_select`` plain version against the Pallas kernel
  (interpret mode, several tiles): bitwise picks, gumbel within the
  ``log`` ulp rule of tests/test_torch_kernels.py;
- ``colony_step`` quantised: tours, best_len and key bitwise on both
  routes; payload, scale and err bitwise on the pure route and for MMAS on
  the kernel route; dequantised tau at rtol 1e-4 / atol 1e-6 for AS and
  ACS on the kernel route (the reference's own quant tolerance,
  tests/test_quant.py), where the Pallas update's fused evaporation moves
  an ulp of the fp32 tau that the scale inherits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aco as jaco  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core import tsp as jtsp  # noqa: E402
from repro.kernels import fused_select as jfs  # noqa: E402
from repro.optim.compression import quantize_int8 as j_quantize_int8  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aco as taco  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import fused_select as fs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.optim.compression import quantize_int8  # noqa: E402
from torch_parity import assert_bitwise, assert_picks, jax_scores  # noqa: E402
from torch_parity import selection_inputs  # noqa: E402

MODES = ["iroulette", "greedy", "gumbel"]


def _bits(x) -> np.ndarray:
    """A payload as comparable integers (bfloat16 through its 16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iu":
        x = x.view(np.int16)
    return x


def _assert_quant(j, t, what=""):
    assert_bitwise(_bits(j.q), _bits(t.q), f"{what} payload")
    assert_bitwise(j.scale, t.scale, f"{what} scale")
    assert_bitwise(j.err, t.err, f"{what} err")


def _tau_input(seed=0, shape=(40, 37)):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 1e-3 + 1e-5).astype(np.float32)
    x[3] *= 50                 # a hot row
    x[5] = -x[5]               # sign bit set: uint32 patterns >= 2**31
    x[7, :5] = 0.0
    err = (rng.standard_normal(shape) * 1e-6).astype(np.float32)
    return x, err


def _keys(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.tensor(np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("axis", [None, -1])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_int8_bitwise(axis, stochastic):
    x, _ = _tau_input(1)
    jk, tk = _keys(5) if stochastic else (None, None)
    q, s = j_quantize_int8(jnp.asarray(x), key=jk, axis=axis)
    tq_, ts = quantize_int8(torch.tensor(x), key=tk, axis=axis)
    assert_bitwise(q, tq_, "eager q")
    assert_bitwise(s, ts, "eager scale")
    q, s = jax.jit(lambda v, k: j_quantize_int8(v, key=k, axis=axis))(
        jnp.asarray(x), jk)
    tq_, ts = quantize_int8(torch.tensor(x), key=tk, axis=axis,
                            compiled=True)
    assert_bitwise(q, tq_, "jitted q")
    assert_bitwise(s, ts, "jitted scale")


@pytest.mark.parametrize("tau_dtype,compensation,stochastic", [
    ("bf16", True, True), ("bf16", False, False), ("int8", True, True),
    ("int8", True, False), ("int8", False, True)])
def test_quantise_requantise_dequantise_bitwise(tau_dtype, compensation,
                                                stochastic):
    x, err = _tau_input(2)
    jk, tk = _keys(3) if stochastic else (None, None)
    a = jq.quantise(jnp.asarray(x), tau_dtype, compensation=compensation,
                    key=jk, err=jnp.asarray(err))
    b = tq.quantise(torch.tensor(x), tau_dtype, compensation=compensation,
                    key=tk, err=torch.tensor(err))
    _assert_quant(a, b, "quantise")
    assert_bitwise(jq.dequantise(a), tq.dequantise(b), "dequantise")
    assert jq.tau_nbytes(a) == tq.tau_nbytes(b)
    x2 = (x * np.float32(1.3)).astype(np.float32)
    c = jax.jit(jq.requantise, static_argnames="tau_dtype")(
        jnp.asarray(x2), a, tau_dtype, jk)
    d = tq.requantise(torch.tensor(x2), b, tau_dtype, tk)
    _assert_quant(c, d, "requantise")
    rows = np.array([0, 3, 3, 5])
    assert_bitwise(jq.dequantise_rows(c.q[rows], c.scale[rows]
                                      if tau_dtype == "int8" else None),
                   tq.dequantise_rows(d.q[rows], d.scale[rows]
                                      if tau_dtype == "int8" else None),
                   "dequantise_rows")


@pytest.mark.parametrize("tau_dtype", ["bf16", "int8"])
def test_zero_width_store_and_nbytes(tau_dtype):
    x = np.zeros((6, 0), np.float32)
    a = jq.quantise(jnp.asarray(x), tau_dtype, compensation=True)
    b = tq.quantise(torch.tensor(x), tau_dtype, compensation=True)
    for fj, ft in zip(a, b):
        assert tuple(fj.shape) == tuple(ft.shape)
    assert_bitwise(a.scale, b.scale, "zero-width scale")
    assert b.q.dtype == (torch.int8 if tau_dtype == "int8"
                         else torch.bfloat16)
    assert jq.tau_nbytes(a) == tq.tau_nbytes(b)
    full = np.full((9, 9), 0.25, np.float32)
    assert tq.tau_nbytes(torch.tensor(full)) == jq.tau_nbytes(
        jnp.asarray(full)) == 324
    assert tq.tau_nbytes(tq.quantise(torch.tensor(full), tau_dtype)) == \
        jq.tau_nbytes(jq.quantise(jnp.asarray(full), tau_dtype))


def test_validation_and_round_key_follow_the_reference():
    for bad in (dict(tau_dtype="fp16"), dict(tau_dtype="int8",
                                             tau_round="up")):
        with pytest.raises(ValueError) as want:
            jq.validate_tau_dtype(**bad)
        with pytest.raises(ValueError) as got:
            tq.validate_tau_dtype(**bad)
        assert str(got.value) == str(want.value)
    assert tq.is_quantised("bf16") and not tq.is_quantised("fp32")
    key = torch.tensor([0, 1])
    assert tq.round_key("nearest", key) is None
    assert tq.round_key("stochastic", key) is key


def _quant_payload(tau, tau_dtype, seed):
    """A payload both packages hold: the reference's stochastic quantise."""
    qt = jq.quantise(jnp.asarray(tau), tau_dtype,
                     key=jax.random.PRNGKey(seed))
    scale = np.asarray(qt.scale) if tau_dtype == "int8" else None
    t_q = torch.from_numpy(_bits(qt.q).copy())
    if tau_dtype == "bf16":
        t_q = t_q.view(torch.bfloat16)
    return qt.q, scale, t_q, None if scale is None else torch.tensor(scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tau_dtype,m,n,n_actual", [("int8", 11, 57, 45),
                                                    ("bf16", 13, 40, None)])
def test_fused_select_quant_plain_vs_pallas(mode, tau_dtype, m, n, n_actual):
    """n is no multiple of the 16-wide tile, so the Pallas grid has several
    tiles and a padded last one; the int8 case is masked (n_actual)."""
    tau, eta, visited, rand, cur = selection_inputs(m, n, 5 * m + n)
    j_q, scale, t_q, t_scale = _quant_payload(tau, tau_dtype, m)
    na = None if n_actual is None else jnp.asarray(n_actual, jnp.int32)
    want = jfs.fused_select(j_q, eta, cur, visited, rand, 1.0, 2.0, na, mode,
                            tau_scale=scale, block_n=16, interpret=True)
    args = (t_q, t_scale, torch.tensor(eta), torch.tensor(cur),
            torch.tensor(visited), torch.tensor(rand), 1.0, 2.0, n_actual,
            mode)
    got = fs.fused_select_quant_plain(*args)
    rows = (np.asarray(jq.dequantise_rows(j_q, scale)) * (eta * eta))[cur]
    assert_picks(want, got, mode,
                 jax_scores(rows, visited, rand, n_actual, mode))
    # ops routes a quantised payload on a CPU tensor to the plain version
    assert torch.equal(ops.fused_select(args[0], *args[2:],
                                        tau_scale=t_scale), got)
    assert ref.fused_select_quant is fs.fused_select_quant_plain


def _quant_pair(inst, kw):
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jaco.make_problem(inst, cj.nn_k)
    pt = taco.make_problem(inst, ct.nn_k, device="cpu")
    return (cj, pj, jaco.init_colony(inst, cj)), \
        (ct, pt, taco.init_colony(inst, ct, device="cpu"))


def _assert_quant_state(sj, st, tau_exact, what):
    assert_bitwise(sj.best_tour, st.best_tour, f"{what} best_tour")
    assert_bitwise(sj.best_len, st.best_len, f"{what} best_len")
    assert_bitwise(np.asarray(sj.key).astype(np.int64), st.key, f"{what} key")
    assert isinstance(st.tau, tq.QuantTau)
    if tau_exact:
        _assert_quant(sj.tau, st.tau, what)
    else:
        np.testing.assert_allclose(np.asarray(jq.dequantise(sj.tau)),
                                   tq.dequantise(st.tau).numpy(), rtol=1e-4,
                                   atol=1e-6)


# (variant, tau_dtype, tau_round, compensation, rho, use_pallas)
QUANT_CASES = [
    ("as", "bf16", "stochastic", False, 0.1, False),
    ("mmas", "int8", "nearest", True, 0.1, False),
    ("acs", "int8", "stochastic", False, 0.5, False),
    ("mmas", "int8", "stochastic", False, 0.5, True),
    ("mmas", "bf16", "nearest", False, 0.5, True),
    ("as", "int8", "stochastic", False, 0.1, True),
    ("acs", "bf16", "stochastic", False, 0.5, True),
]


@pytest.mark.parametrize("variant,tau_dtype,tau_round,comp,rho,use_pallas",
                         QUANT_CASES)
def test_quantised_colony_step_vs_jax(variant, tau_dtype, tau_round, comp,
                                      rho, use_pallas):
    inst = jtsp.random_instance(26, seed=4)
    kw = dict(variant=variant, tau_dtype=tau_dtype, tau_round=tau_round,
              tau_compensation=comp, rho=rho, use_pallas=use_pallas, seed=6,
              nn_k=8)
    (cj, pj, sj), (ct, pt, st) = _quant_pair(inst, kw)
    _assert_quant(sj.tau, st.tau, "init")
    exact = not use_pallas or variant == "mmas"
    ops.reset_launch_counts()
    for i in range(3):
        sj, bj = jaco.colony_step(pj, sj, cj)
        st, bt = taco.colony_step(pt, st, ct)
        assert_bitwise(bj, bt, f"step {i} iteration-best length")
        _assert_quant_state(sj, st, exact, f"step {i}")
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("tau_dtype", ["bf16", "int8"])
def test_quantised_run_resumes_from_converted_jax_state(tau_dtype):
    """A JAX quantised colony handed over mid-run continues in the port as
    the JAX run does; the state converts back with its payload bits."""
    inst = jtsp.circle_instance(21, seed=2)
    kw = dict(variant="mmas", tau_dtype=tau_dtype, rho=0.1, seed=8, nn_k=8,
              iterations=4)
    cj, ct = jaco.ACOConfig(**kw), taco.ACOConfig(**kw)
    pj = jaco.make_problem(inst, 8)
    sj = jaco.init_colony(inst, cj)
    for _ in range(2):
        sj, _ = jaco.colony_step(pj, sj, cj)
    st = convert.state_from_numpy(
        *(x if isinstance(x, tuple) else np.asarray(x) for x in sj),
        device="cpu")
    _assert_quant(sj.tau, st.tau, "converted")
    want = jaco.run(inst, cj, state=sj)
    got = taco.run(inst, ct, state=st)
    _assert_quant_state(want, got, True, "resumed run")
    back = convert.state_to_numpy(got)
    assert isinstance(back["tau"], tuple)
    assert_bitwise(_bits(want.tau.q), back["tau"][0], "payload round trip")
    again = convert.state_from_numpy(**back, device="cpu")
    _assert_quant(want.tau, again.tau, "round trip")
