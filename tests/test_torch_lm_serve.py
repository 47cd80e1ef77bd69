"""Port parity for the serving entry point: repro_torch.launch.serve against
repro.launch.serve.

``serve("qwen2_vl_2b", batch=2, prompt_len=8, gen=6)`` is the shape of the
reference's own end-to-end test (tests/test_archs.py::
test_serve_end_to_end).  The port's ``init_params`` is replaced by the
reference's weights (carried across by ``convert``) and its prompts are
the reference's (the port's threefry ``randint``), so the generated
tokens are the reference's, all six of each row.  The same holds for the
two MoE architectures, grok-1 and deepseek-v3 (MLA), at their reduced
configs.  ``main`` prints the reference's report keys; the three
families still to port (Mamba for jamba and mamba2, the encoder-decoder
for whisper) raise ``NotImplementedError`` naming their ROADMAP item.
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
NOT_PORTED = {
    "jamba_1_5_large_398b": r"18\.3 \(Mamba",
    "mamba2_1_3b": r"18\.3 \(Mamba",
    "whisper_medium": r"18\.4 \(encoder-decoder\)",
}


@pytest.fixture(scope="module")
def reference():
    return jserve.serve(ARCH, batch=2, prompt_len=8, gen=6, reduced=True)


def _serve_on_the_reference_weights(arch, monkeypatch):
    """The port's ``serve`` with ``init_params`` giving the reference's
    weights for ``arch`` (``jserve.serve`` draws them from key 0)."""
    tree = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jconfigs.get_reduced(arch)))
    monkeypatch.setattr(
        tserve.model, "init_params",
        lambda cfg, gen, dev: convert.lm_params_from_numpy(cfg, tree, dev))
    return tserve.serve(arch, batch=2, prompt_len=8, gen=6, device="cpu")


def test_serve_tokens_are_the_reference(reference, monkeypatch):
    got = _serve_on_the_reference_weights(ARCH, monkeypatch)
    assert set(got) == set(reference)
    assert np.asarray(got["tokens"]).shape == (2, 6)
    assert got["tokens"] == reference["tokens"]
    assert got["decode_s_per_token"] > 0 and got["throughput_tok_s"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_tokens_are_the_reference(arch, monkeypatch):
    """grok-1 and deepseek-v3 reduced, bf16: the reference's six tokens
    of each row (the reference's own end-to-end shape)."""
    want = jserve.serve(arch, batch=2, prompt_len=8, gen=6, reduced=True)
    got = _serve_on_the_reference_weights(arch, monkeypatch)
    assert set(got) == set(want)
    assert np.asarray(got["tokens"]).shape == (2, 6)
    assert got["tokens"] == want["tokens"]


def test_main_prints_the_reference_report(reference, capsys):
    tserve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4",
                 "--gen", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(reference) - {"tokens"}
    assert all(v > 0 for v in out.values())


@pytest.mark.parametrize("arch", list(NOT_PORTED))
def test_families_still_to_port_raise(arch):
    with pytest.raises(NotImplementedError, match=NOT_PORTED[arch]) as err:
        tserve.serve(arch, batch=1, prompt_len=2, gen=2, device="cpu")
    # MoE (18.1) and MLA (18.2) are ported: only the missing family is named
    assert "18.1" not in str(err.value) and "18.2" not in str(err.value)


def test_training_raises_naming_its_item():
    from repro_torch.models import model
    with pytest.raises(NotImplementedError, match=r"18\.5 \(training\)"):
        model.loss_fn()


def test_serve_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: serve runs there by default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, batch=1, prompt_len=2, gen=2)
