"""Port parity for the serving entry point: repro_torch.launch.serve against
repro.launch.serve.

``serve("qwen2_vl_2b", batch=2, prompt_len=8, gen=6)`` is the shape of the
reference's own end-to-end test (tests/test_archs.py::
test_serve_end_to_end).  The port's ``init_params`` is replaced by the
reference's weights (carried across by ``convert``) and its prompts are
the reference's (the port's threefry ``randint``), so the generated
tokens are the reference's, all six of each row.  The same holds for the
two MoE architectures, grok-1 and deepseek-v3 (MLA), for Mamba2, the
Jamba hybrid (Mamba, attention and MoE) and whisper's encoder-decoder,
at their reduced configs; whisper's encoder frames are the port's
``sampling.normal`` draw, ulp-close to the reference's.  ``main`` prints
the reference's report keys, and every one of the ten architectures
serves on the CPU.  ``sharding.to_shardings`` over a mesh of two
positions places each parameter's shards on their positions.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARCH = "qwen2_vl_2b"
MOE_ARCHS = ("grok_1_314b", "deepseek_v3_671b")
SSM_ENCDEC_ARCHS = ("mamba2_1_3b", "jamba_1_5_large_398b", "whisper_medium")


def _reference_serve(arch):
    """The reference's ``serve`` of ``arch`` -> (its report, the weights
    it drew from key 0 (its ``init_params``, recorded), as NumPy)."""
    trees = []
    init = jm.init_params

    def recording(key, cfg):
        trees.append(init(key, cfg))
        return trees[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "init_params", recording)
        report = jserve.serve(arch, batch=2, prompt_len=8, gen=6,
                              reduced=True)
    return report, jax.tree.map(np.asarray, trees[0])


@pytest.fixture(scope="module")
def reference_run():
    return _reference_serve(ARCH)


@pytest.fixture(scope="module")
def reference(reference_run):
    return reference_run[0]


def _serve_on_the_reference_weights(arch, tree, monkeypatch):
    """The port's ``serve`` with ``init_params`` giving the reference's
    weights ``tree`` for ``arch``."""
    monkeypatch.setattr(
        tserve.model, "init_params",
        lambda cfg, gen, dev: convert.lm_params_from_numpy(cfg, tree, dev))
    return tserve.serve(arch, batch=2, prompt_len=8, gen=6, device="cpu")


def test_serve_tokens_are_the_reference(reference_run, monkeypatch):
    reference, tree = reference_run
    got = _serve_on_the_reference_weights(ARCH, tree, monkeypatch)
    assert set(got) == set(reference)
    assert np.asarray(got["tokens"]).shape == (2, 6)
    assert got["tokens"] == reference["tokens"]
    assert got["decode_s_per_token"] > 0 and got["throughput_tok_s"] > 0


def _assert_serves_the_references_tokens(arch, monkeypatch):
    want, tree = _reference_serve(arch)
    got = _serve_on_the_reference_weights(arch, tree, monkeypatch)
    assert set(got) == set(want)
    assert np.asarray(got["tokens"]).shape == (2, 6)
    assert got["tokens"] == want["tokens"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_tokens_are_the_reference(arch, monkeypatch):
    """grok-1 and deepseek-v3 reduced, bf16: the reference's six tokens
    of each row (the reference's own end-to-end shape)."""
    _assert_serves_the_references_tokens(arch, monkeypatch)


@pytest.mark.parametrize("arch", SSM_ENCDEC_ARCHS)
def test_ssm_and_encdec_serve_tokens_are_the_reference(arch, monkeypatch):
    """mamba2, jamba and whisper reduced, bf16: the reference's six
    tokens of each row (whisper encodes 64 frames of the port's
    ``sampling.normal`` draw)."""
    _assert_serves_the_references_tokens(arch, monkeypatch)


def test_main_prints_the_reference_report(reference, capsys):
    tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4",
                 "--gen", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(reference) - {"tokens"}
    assert all(v > 0 for v in out.values())


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_every_arch_serves_on_the_cpu(arch, reference):
    """Every architecture's reduced config through ``serve`` on the CPU,
    on the port's own weights: the reference's report keys and (B, gen)
    tokens in the vocabulary."""
    got = tserve.serve(arch, batch=2, prompt_len=3, gen=3, device="cpu")
    assert set(got) == set(reference)
    toks = np.asarray(got["tokens"])
    assert toks.shape == (2, 3)
    assert ((toks >= 0) & (toks < jconfigs.get_reduced(arch).vocab)).all()


def test_to_shardings_places_each_shard_on_its_position():
    """Over a two-position ``data`` mesh each parameter's shards lie on
    their positions' devices (here the CPU and ``meta``) in the shape
    ``shard_shape`` gives; on two CPU positions an FSDP-sharded weight's
    shards are its two halves and gather back to it."""
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model, sharding
    cfg = configs.get_reduced(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = Mesh([torch.device("cpu"), torch.device("meta")], ("data",))
    specs = sharding.param_specs(params, cfg, mesh)
    placed = sharding.to_shardings(specs, mesh)
    assert set(placed) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        sh = placed[name]
        assert sh.spec == specs[name] and sh.mesh is mesh
        shards = sh.shard(p)
        assert [s.device for s in shards] == mesh.device_list()
        assert all(tuple(s.shape) == sh.shard_shape(p.shape) for s in shards)
    assert any("data" in spec for spec in specs.values())
    cpu2 = Mesh([torch.device("cpu")] * 2, ("data",))
    p = params.get_parameter("blocks.0.mlp.wi")
    sh = sharding.to_shardings(sharding.param_specs(params, cfg, cpu2),
                               cpu2)["blocks.0.mlp.wi"]
    assert sh.spec == ("data", None)
    halves = sh.shard(p)
    assert torch.equal(halves[0], p[:p.shape[0] // 2])
    assert torch.equal(halves[1], p[p.shape[0] // 2:])
    assert torch.equal(sh.gather(halves, "cpu"), p)


def test_serve_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: serve runs there by default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, batch=1, prompt_len=2, gen=2)
