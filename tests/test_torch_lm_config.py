"""Port parity for the LM configs: repro_torch.models.config and
repro_torch.configs against repro.models.config / repro.configs, and the
placement example over them (examples/aco_placement_torch.py against
examples/aco_placement.py).

Configs are data, so everything is equal: every field of ``get`` and
``get_reduced`` for all ten archs (``LayerSpec``s compared as tuples),
the derived properties, ``param_count``, ``active_param_count``,
``layer_specs``, ``is_subquadratic``, the dtypes by name, the registry
and ``canonical``'s error.  The example's problems are equal for every
arch, and its deepseek-v3 report (the uniform split and a 120-iteration
colony of 64 ants) is the reference's bit for bit, the tolerance of
tests/test_torch_placement.py's ``solve`` test.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jc  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DERIVED = ("n_periods", "d_inner", "ssm_heads", "ff_expert", "ff_dense",
           "is_subquadratic")


@pytest.mark.parametrize("arch", jc.ARCHS)
def test_configs_are_the_reference(arch):
    for getter in ("get", "get_reduced"):
        want, got = getattr(jc, getter)(arch), getattr(tc, getter)(arch)
        assert dataclasses.astuple(want) == dataclasses.astuple(got), getter
        assert ([f.name for f in dataclasses.fields(want)]
                == [f.name for f in dataclasses.fields(got)])
        for name in DERIVED:
            assert getattr(want, name) == getattr(got, name), (getter, name)
        assert want.param_count() == got.param_count()
        assert want.active_param_count() == got.active_param_count()
        assert ([dataclasses.astuple(s) for s in want.layer_specs()]
                == [dataclasses.astuple(s) for s in got.layer_specs()])
        assert str(got.pdtype) == f"torch.{want.pdtype.name}"
        assert str(got.cdtype) == f"torch.{want.cdtype.name}"


def test_registry_and_canonical_are_the_reference():
    assert jc.ARCHS == tc.ARCHS and jc.ALIASES == tc.ALIASES
    assert list(jc.all_configs()) == list(tc.all_configs())
    for name in list(jc.ARCHS) + list(jc.ALIASES) + ["qwen2.vl.2b"]:
        assert jc.canonical(name) == tc.canonical(name)
    with pytest.raises(KeyError) as want:
        jc.canonical("llama_3_8b")
    with pytest.raises(KeyError) as got:
        tc.canonical("llama_3_8b")
    assert str(want.value) == str(got.value)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_placement_example_problems_are_the_reference():
    ej, et = _example("aco_placement"), _example("aco_placement_torch")
    for arch in jc.ARCHS:
        pj, pt = ej.model_problem(arch, 8), et.model_problem(arch, 8)
        assert pj.layer_costs == pt.layer_costs, arch
        assert pj.edge_traffic == pt.edge_traffic, arch
        assert (pj.n_stages, pj.comm_lambda) == (pt.n_stages, pt.comm_lambda)


def _report(mod, monkeypatch, capsys, *args):
    """Run ``mod._report`` and keep what its solvers returned."""
    got = {}
    for fn in ("uniform_baseline", "solve"):
        orig = getattr(mod.placement, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            got[_fn] = _orig(*a, **kw)
            return got[_fn]
        monkeypatch.setattr(mod.placement, fn, spy)
    mod._report("deepseek-v3 / 8 stages",
                mod.model_problem("deepseek_v3_671b", 8), *args)
    monkeypatch.undo()
    return got, capsys.readouterr().out


def test_placement_example_report_is_the_reference(monkeypatch, capsys):
    ej, et = _example("aco_placement"), _example("aco_placement_torch")
    want, out_j = _report(ej, monkeypatch, capsys)
    got, out_t = _report(et, monkeypatch, capsys, "cpu")
    for fn in ("uniform_baseline", "solve"):
        assert_bitwise(want[fn][0], got[fn][0], f"{fn} assignment")
        assert np.float32(want[fn][1]) == np.float32(got[fn][1]), fn
    assert out_t == out_j
