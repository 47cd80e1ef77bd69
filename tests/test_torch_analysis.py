"""The port's op-level accounting, repro_torch.analysis.ops, against the
reference's HLO accounting, repro.analysis.hlo.

For each of the ten reduced configs the reference's prefill, decode and
train steps (train with ``remat=True``) are jitted at batch 2, seq 64
(whisper with 64 frames; decode over a 64-position cache) and compiled
once, one compiled program per step kind and config; ``hlo.accumulate``
of the compiled text (LLVM codegen at -O0, the HLO passes as always)
gives their dot FLOPs.  The port's steps run on
``meta`` under ``ops.accumulate``: its dot FLOPs (2 x output elements x
contracted elements of every matrix product dispatched, forward and
backward) equal the reference's exactly.  The train step's equality
rests on the remat boundary: the port leaves the prefix layers plain and
checkpoints each period of the body as one unit, as the reference's
scanned body is checkpointed (deepseek-v3's dense prefix and jamba's
period of eight are where a per-layer checkpoint differed: +3.96% and
-1.45% of the reference's FLOPs).  Remat changes the schedule only: the
loss and gradients with and without it are bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import hlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import ops  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402

from torch_parity import assert_bitwise  # noqa: E402

B, S, ENC = 2, 64, 64
FAST = {"xla_backend_optimization_level": "0"}
META = torch.device("meta")
ARCHS = sorted(tconfigs.ARCHS)



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's small CPU steps (the suite runs
    several workers, whose threads would contend); both sides of every
    port-to-port comparison run with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _reference_flops(arch: str) -> dict:
    """{step kind: the dot FLOPs of the reference's compiled step}."""
    cfg = jconfigs.get_reduced(arch)
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tok = sds((B, S), jnp.int32)
    extra = ((sds((B, ENC, cfg.d_model), jnp.bfloat16),) if cfg.enc_dec
             else ())
    caches = jax.eval_shape(lambda: jm.init_cache(
        cfg, B, S, enc_len=ENC if cfg.enc_dec else 0))
    opt = jax.eval_shape(ja.adamw_init, params)
    lowered = {
        "prefill": jax.jit(jsteps.make_prefill_step(cfg)).lower(
            params, tok, *extra),
        "decode": jax.jit(jsteps.make_serve_step(cfg)).lower(
            params, sds((B, 1), jnp.int32), caches),
        "train": jax.jit(jsteps.make_train_step(
            cfg, ja.AdamWConfig(), remat=True)).lower(
                params, opt, tok, tok, *extra)}
    # LLVM's codegen at -O0 (a third less compile time); the HLO passes
    # that decide the products (fusion, CSE, the remat schedule) run as
    # they always do
    return {k: hlo.accumulate(v.compile(compiler_options=FAST).as_text())[
        "dot_flops"] for k, v in lowered.items()}


def _port_steps(arch: str) -> dict:
    """{step kind: (the port's step, its ``meta`` arguments)}."""
    cfg = tconfigs.get_reduced(arch)
    params = tm.Model(cfg, None, META)
    tok = torch.empty((B, S), dtype=torch.int32, device=META)
    frames = (torch.empty((B, ENC, cfg.d_model), dtype=torch.bfloat16,
                          device=META) if cfg.enc_dec else None)
    caches = tm.init_cache(cfg, B, S, META, enc_len=ENC if cfg.enc_dec
                           else 0)
    return {
        "prefill": (tsteps.make_prefill_step(cfg), (params, tok, frames)),
        "decode": (tsteps.make_serve_step(cfg),
                   (params, tok[:, :1], caches)),
        "train": (tsteps.make_train_step(cfg, ta.AdamWConfig()),
                  (params, ta.adamw_init(params), tok, tok, frames))}


@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_equal_the_references_hlo(arch):
    """Prefill, decode and train (remat) of the reduced config: the
    port's dot FLOPs on ``meta`` equal ``hlo.accumulate`` of the
    reference's compiled step, exactly."""
    want = _reference_flops(arch)
    for kind, (step, args) in _port_steps(arch).items():
        got = ops.accumulate(step, *args)["dot_flops"]
        assert got == want[kind], (arch, kind, got, want[kind])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_step_traces_on_meta(arch):
    """Each arch's three steps run on ``meta`` (``bincount`` and an
    unsized ``repeat_interleave`` had no meta kernel): finite counts,
    arguments and temporaries above zero, nothing collective on one
    position, and the outputs' shapes the steps'."""
    cfg = tconfigs.get_reduced(arch)
    for kind, (step, args) in _port_steps(arch).items():
        rec = ops.accumulate(step, *args)
        assert rec["dot_flops"] > 0 and rec["bytes_accessed"] > 0, kind
        assert rec["memory"]["argument_size_in_bytes"] > 0, kind
        assert rec["memory"]["temp_size_in_bytes"] > 0, kind
        assert rec["collective_total"] == rec["collective_count"] == 0
        out = rec["out"]
        if kind == "prefill":
            assert tuple(out.shape) == (B, S, cfg.vocab)
        elif kind == "decode":
            assert tuple(out[0].shape) == (B, 1) and out[0].device == META
        else:
            assert set(out[2]) >= {"loss", "grad_norm", "lr"}


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "jamba_1_5_large_398b"])
def test_remat_changes_no_value(arch):
    """The per-period checkpoint recomputes, it does not change what is
    computed: the loss, its parts and every gradient with ``remat`` are
    bitwise those without, on the reduced config at float32 (the two
    configs whose checkpoint boundary moved: a dense prefix, a period of
    eight)."""
    cfg = dataclasses.replace(tconfigs.get_reduced(arch),
                              param_dtype="float32", compute_dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params.requires_grad_(True)
    gen = np.random.default_rng(1)
    tok = torch.from_numpy(gen.integers(0, cfg.vocab, (B, 16)).astype(
        np.int32))
    out = []
    for remat in (False, True):
        params.zero_grad(set_to_none=True)
        loss, metrics = tm.loss_fn(params, tok, tok, cfg, remat=remat)
        loss.backward()
        out.append((metrics, {n: p.grad.clone()
                              for n, p in params.named_parameters()}))
    (m0, g0), (m1, g1) = out
    for k in m0:
        assert_bitwise(m0[k].detach(), m1[k].detach(), k)
    for n in g0:
        assert_bitwise(g0[n], g1[n], n)


def test_collectives_report_only_inside_an_accumulator():
    """Outside ``accumulate`` the collectives report nothing and return
    what they did before; inside, each reports every position's output
    bytes under the reference's kind."""
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    mesh = Mesh(devs, ("data",))
    xs = [torch.full((3,), float(i)) for i in range(4)]
    plain = collectives.psum(xs, "data", mesh)
    assert ops.runs(3) and ops.folded() == 1 and ops.here() == (0,)

    def run():
        return (collectives.psum(xs, "data", mesh),
                collectives.all_gather(xs, "data", mesh),
                collectives.ppermute(xs, "data", [(0, 1)], mesh))

    rec = ops.accumulate(run, mesh=mesh)
    for a, b in zip(plain, rec["out"][0]):
        assert_bitwise(a, b, "psum")
    assert rec["collective_bytes"] == {"all-reduce": 12, "all-gather": 48,
                                       "collective-permute": 12}
    assert rec["collective_count"] == 3
    assert rec["positions"]["collective_bytes/all-gather"] == [48.0] * 4
    assert ops._ACTIVE is None
