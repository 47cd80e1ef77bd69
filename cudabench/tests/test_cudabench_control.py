"""``correct`` fails the control and the faults a cell can have.

The control: the plain reference with bfloat16 weights in the program's
place.  The faults: a step that returns its state unchanged; half of the
ants' (or half of the slots') work left out; an answer altered where it is
produced.  Each run skips the harness's look for a card and drives the
rest of a run on the CPU at a small size."""
import dataclasses
import time

import pytest
import torch

from conftest import BENCH, small_cell
from cudabench import control, run
from repro_torch.core import aco
from repro_torch.kernels import ops as kops
from repro_torch.solver import streaming


def _correct(cell, seed=3):
    return run.measure(cell, seed, 1.0, False, "cpu",
                       time.perf_counter())["correct"]


def test_control_is_not_correct(small):
    with control.program_replaced(control.reference_step()):
        assert _correct(small) is False


def test_control_in_float32_is_correct(small):
    with control.program_replaced(control.reference_step(torch.float32)):
        assert _correct(small) is True


def _unchanged(problem, states, cfg, **kw):
    return states, states.best_len


def _half_the_work(monkeypatch):
    real = kops.pheromone_update

    def half(tau, tours, w, rho, n_actual=None, active=None):
        m = tours.shape[-2] // 2
        return real(tau, tours[..., :m, :].contiguous(),
                    2 * w[..., :m].contiguous(), rho, n_actual, active)
    monkeypatch.setattr(kops, "pheromone_update", half)


def _altered(monkeypatch):
    real = aco.colony_step_batch

    def step(*a, **k):
        out = real(*a, **k)
        st = out[0]
        tour = st.best_tour.clone()
        tour[..., [0, 1]] = tour[..., [1, 0]]
        return (st._replace(best_tour=tour),) + tuple(out[1:])
    monkeypatch.setattr(aco, "colony_step_batch", step)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_are_not_correct(small, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(aco, "colony_step_batch", _unchanged)
        small.traffic = dict(small.traffic, drain_s=2.0)
    elif fault == "half":
        _half_the_work(monkeypatch)
    else:
        _altered(monkeypatch)
    assert _correct(small) is False


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["config"] == "as-stream"])
def test_altered_result_is_not_correct(name, monkeypatch):
    small = small_cell(name)
    real = streaming.SolveResult

    def result(**kw):
        tour = kw["best_tour"].copy()
        tour[[0, 1]] = tour[[1, 0]]
        return real(**dict(kw, best_tour=tour))
    monkeypatch.setattr(streaming, "SolveResult", result)
    assert _correct(small) is False
