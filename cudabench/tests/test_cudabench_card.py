"""The harness on the card at a small size: each cell's kernel route is
correct, and the control is not.  Every test skips without a CUDA card
(decided inside the test):

    python -m pytest -q -m cuda cudabench/tests/test_cudabench_card.py
"""
import time

import pytest
import torch

from conftest import BENCH, small_cell
from cudabench import control, run

CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return "cuda"


def _measure(name, seed):
    return run.measure(small_cell(name), seed, 1.0, False, _card(),
                       time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card_is_correct(name):
    res = _measure(name, 2**31 + 17)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"] is True, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_on_the_card_is_not_correct(name):
    with control.program_replaced(control.reference_step()):
        res = _measure(name, 2**31 + 19)
    assert res["correct"] is False, res["checks"]
