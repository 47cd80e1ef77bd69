"""Port parity for the train step and the trainer: repro_torch.launch.steps.
make_train_step against the reference's jitted repro.launch.steps.
make_train_step, and repro_torch.launch.train on the CPU; the smoke runs
of the three examples written for the port.

Three steps of each side's own train step from the same weights, on the
reference's synthetic batches (batch 2, seq 32, lr 3e-3 warming up over
one step): olmo and deepseek-v3 (MLA, MoE, the MTP head) at float32, and
olmo with ``compress=True`` (the int8 round trip of the gradients, one
scale a reference leaf).  Held after every step: the loss and its parts
within 16 f32 ulps of the loss (measured at most 1), the global norm
within 64 f32 ulps (measured at most 26), the learning rate bitwise.
After the three steps the parameters are within ``PARAM_LR`` x lr of the
reference's, 0.1 (measured 0.028, deepseek-v3).  Adam divides each
gradient by its own running RMS, so an element whose gradient is near
zero turns the gradients' rounding (64 ulps of the leaf's scale) into an
update of order lr, and each later gradient starts from parameters that
differ by that much.  So each step is also run from the reference's own
state before it, and held there: the parameters within ``STEP_LR`` x lr,
0.1 (measured 0.028 on the first step, at most 9.3e-5 on the later
ones), the first moments within 64 f32 ulps of each leaf's scale
(measured at most 25), the second moments, squares of the gradients,
within 128 (measured at most 44), the step count equal.

``train()`` on the CPU: the reduced olmo's loss falls below 0.9 x its
first step's in 40 steps at batch 4, seq 64, lr 3e-3 (the property the
reference's own test asks of its trainer); a run restarted from its step-3
checkpoint writes a step-6 checkpoint bitwise the straight run's; every
architecture trains two steps (whisper on the stub frames); the CLI
prints its JSON line last; without a GPU it needs ``device``.  The
training example also runs one step on a (2, 2) mesh of CPU positions.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig, SyntheticLMData  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from torch_parity import F32_BITS, ulp_of_scale  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_CASES = {"olmo_1b": ("olmo_1b", False),
              "deepseek_v3_671b": ("deepseek_v3_671b", False),
              "olmo_1b+compress": ("olmo_1b", True)}
STEPS, BATCH, SEQ = 3, 2, 32
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)
LOSS_ULPS, NORM_ULPS = 16, 64
PARAM_LR, STEP_LR, MU_ULPS, NU_ULPS = 0.1, 0.1, 64, 128


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's small CPU steps: under the
    suite's parallel workers a thread pool per process oversubscribes the
    cores (the 40-step ``train`` ran 99 s beside them against 3 s alone).
    Both sides of each bitwise comparison run with the same count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(configs, arch):
    return dataclasses.replace(configs.get_reduced(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _batches(cfg):
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=0))
    return [next(data) for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's weights and its jitted train step run STEPS times:
    each step's metrics, and the parameters and optimizer state before
    and after each step (NumPy)."""
    arch, compress = STEP_CASES[case]
    cfg = _cfg(jconfigs, arch)
    tree = jm.init_params(jax.random.PRNGKey(0), cfg)
    host = functools.partial(jax.tree.map, np.asarray)
    step = jax.jit(jsteps.make_train_step(cfg, ja.AdamWConfig(**OPT),
                                          remat=True, compress=compress))
    opt = ja.adamw_init(tree)
    metrics, states = [], [(host(tree), host(opt))]
    for tokens, labels in _batches(cfg):
        tree, opt, m = step(tree, opt, tokens, labels)
        metrics.append(host(m))
        states.append((host(tree), host(opt)))
    return metrics, states


def _port_state(cfg, state):
    """A reference (params, AdamWState) -> the port's."""
    tree, opt = state
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    return params, convert.lm_opt_state_from_numpy(params, opt.mu, opt.nu,
                                                   opt.step)


def _worst_ulps(want_tree, got_tree) -> float:
    """The largest error of any leaf in f32 ulps of that leaf's scale."""
    return max(float(np.abs(w - g).max()) / ulp_of_scale(w, F32_BITS)
               for w, g in zip(jax.tree.leaves(want_tree),
                               jax.tree.leaves(got_tree)))


def _max_abs(want_tree, got_tree) -> float:
    return max(float(np.abs(w - g).max()) for w, g in
               zip(jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_is_the_references(case):
    arch, compress = STEP_CASES[case]
    want_m, states = _reference(case)
    cfg = _cfg(tconfigs, arch)
    lr = OPT["lr"]
    step = tsteps.make_train_step(cfg, ta.AdamWConfig(**OPT), remat=True,
                                  compress=compress)
    # the port's own three steps from the reference's weights
    params, opt = _port_state(cfg, states[0])
    for i, (tokens, labels) in enumerate(_batches(cfg)):
        params, opt, got = step(params, opt, torch.from_numpy(tokens),
                                torch.from_numpy(labels))
        want = want_m[i]
        assert set(got) == set(want)
        unit = ulp_of_scale(want["loss"], F32_BITS)
        for k in set(want) - {"grad_norm", "lr"}:
            err = abs(float(want[k]) - got[k].item()) / unit
            assert err <= LOSS_ULPS, (i, k, err)
        norm = abs(float(want["grad_norm"]) - got["grad_norm"].item())
        assert norm <= NORM_ULPS * ulp_of_scale(want["grad_norm"],
                                                F32_BITS), (i, norm)
        assert np.float32(want["lr"]) == np.float32(got["lr"].item())
    assert int(opt.step) == STEPS
    drift = _max_abs(states[-1][0], convert.lm_params_to_numpy(params)) / lr
    assert drift <= PARAM_LR, drift
    # each step from the reference's state before it
    report = []
    for i, (tokens, labels) in enumerate(_batches(cfg)):
        params, opt = _port_state(cfg, states[i])
        params, opt, _ = step(params, opt, torch.from_numpy(tokens),
                              torch.from_numpy(labels))
        want_p, want_o = states[i + 1]
        got_o = convert.lm_opt_state_to_numpy(params, opt)
        assert int(got_o["step"]) == int(want_o.step) == i + 1
        p_err = _max_abs(want_p, convert.lm_params_to_numpy(params)) / lr
        mu_err = _worst_ulps(want_o.mu, got_o["mu"])
        nu_err = _worst_ulps(want_o.nu, got_o["nu"])
        assert p_err <= STEP_LR and mu_err <= MU_ULPS and \
            nu_err <= NU_ULPS, (i, p_err, mu_err, nu_err)
        report.append(f"{p_err:.3g} lr / {mu_err:.3g} / {nu_err:.3g}")
    print(f"{case}: three steps drift {drift:.3g} lr; from the reference's "
          f"state, params / mu / nu: " + ", ".join(report))


def test_train_loss_falls_below_0_9_of_its_first():
    out = ttrain.train("olmo_1b", steps=40, batch=4, seq=64, lr=3e-3,
                       log_every=1, device="cpu")
    losses = out["losses"]
    assert len(losses) == len(out["step_ms"]) == 40
    assert out["final_loss"] == losses[-1] < 0.9 * losses[0], losses


def _ckpt_leaves(path):
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files if k != "__meta__"}


def test_train_restart_is_bitwise_a_straight_run(tmp_path):
    """Six straight steps (checkpoints at 3 and 6) against the same run
    restarted from its step-3 checkpoint: the step-6 checkpoints
    (parameters, both moments, the step, the data cursor) are equal bit
    for bit, and so are the losses of steps 4-6."""
    ckpt = str(tmp_path / "ck")
    kw = dict(steps=6, batch=2, seq=32, ckpt_dir=ckpt, ckpt_every=3,
              log_every=1, device="cpu")
    straight = ttrain.train("olmo_1b", **kw)
    final = os.path.join(ckpt, "ckpt_000000006.npz")
    shutil.move(final, str(tmp_path / "straight.npz"))
    resumed = ttrain.train("olmo_1b", **kw)
    assert resumed["losses"] == straight["losses"][3:]
    want, got = _ckpt_leaves(str(tmp_path / "straight.npz")), \
        _ckpt_leaves(final)
    assert want.keys() == got.keys() and len(want) > 10
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], k)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_every_arch_trains_on_the_cpu(arch):
    out = ttrain.train(arch, steps=2, batch=2, seq=16, log_every=1,
                       device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    vocab = tconfigs.get_reduced(arch).vocab
    assert 0 < out["losses"][0] < 2 * np.log(vocab)


def test_main_prints_its_json_line_last(capsys):
    ttrain.main(["--steps", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[train] step 2/2 loss=")
    out = json.loads(lines[-1])
    assert set(out) == {"final_loss"} and np.isfinite(out["final_loss"])


def test_train_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: train runs there by default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("olmo_1b", steps=1, batch=1, seq=4)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_runs_on_the_cpu(capsys):
    _example("quickstart_torch").main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    for tag in ("[data-parallel AS]", "[kernels]", "[MMAS + 2-opt]",
                "[batched solver]", "[streaming solver]", "[sharded solver]",
                "[sparse MMAS]", "[sparse Partial]"):
        assert tag in out, tag
    assert "gap=-0.00%" in out.splitlines()[1]      # the optimum of circle40


def test_distributed_example_runs_on_the_cpu(capsys):
    _example("distributed_aco_torch").main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    assert "positions: 8 {'data': 4, 'model': 2}" in out
    assert "[islands x4]" in out and "4 islands -> 6 islands" in out
    assert "[city-sharded] n=48" in out


def test_train_lm_example_runs_on_the_cpu(tmp_path, capsys):
    out = _example("train_lm_torch").main(
        ["--quick", "--steps", "20", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)])
    assert len(out["losses"]) == 2 and out["losses"][-1] < out["losses"][0]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000020.npz"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "final loss:")


def test_train_lm_example_runs_on_a_mesh(tmp_path, capsys):
    """The example's quick run for one step on a (2, 2) mesh of CPU
    positions (``--devices 4 --model-parallel 2``)."""
    out = _example("train_lm_torch").main(
        ["--quick", "--steps", "1", "--device", "cpu", "--devices", "4",
         "--model-parallel", "2", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000001.npz"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "final loss:")
