"""Crash-recovery supervisor: the cluster-side fault-tolerance loop.

Wraps any checkpointed iterative workload (ACO colony, island set, LM train
loop) in a restart-on-failure driver:

- the workload exposes (init_state, step_fn, save/restore via
  CheckpointManager);
- on any exception the supervisor restores the newest checkpoint and resumes
  (up to ``max_restarts``), exactly reproducing the uninterrupted trajectory
  because every step is deterministic given the checkpointed state (RNG keys
  live in the state, data is counter-mode);
- a step *deadline* provides coarse straggler/hang mitigation: a step that
  exceeds it raises and triggers the same restore path (on a real cluster
  the replacement pod re-joins from the checkpoint; here the semantics are
  identical in-process).

The port's copy of ``repro.runtime.supervisor`` (it imports no JAX),
over the port's ``CheckpointManager``.  tests/test_torch_service.py
injects crashes mid-run and asserts trajectory equality with an
uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from ..checkpoint import CheckpointManager


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    total_steps: int
    ckpt_every: int = 10
    max_restarts: int = 5
    step_deadline_s: Optional[float] = None   # straggler/hang guard


class Supervisor:
    """Restart-on-failure driver around a (state, step) -> state loop."""

    def __init__(self, cfg: SupervisorConfig, mgr: CheckpointManager,
                 init_fn: Callable[[], Any],
                 step_fn: Callable[[Any, int], Any]):
        self.cfg = cfg
        self.mgr = mgr
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.restarts = 0

    def _restore_or_init(self) -> tuple[Any, int]:
        latest = self.mgr.latest_step()
        if latest is None:
            return self.init_fn(), 0
        state, step = self.mgr.restore(self.init_fn())
        return state, step

    def _run_from(self, state: Any, start: int) -> Any:
        for i in range(start, self.cfg.total_steps):
            t0 = time.monotonic()
            state = self.step_fn(state, i)
            if (self.cfg.step_deadline_s is not None
                    and time.monotonic() - t0 > self.cfg.step_deadline_s):
                raise TimeoutError(
                    f"step {i} exceeded deadline "
                    f"{self.cfg.step_deadline_s}s (straggler/hang)")
            if (i + 1) % self.cfg.ckpt_every == 0 or i == self.cfg.total_steps - 1:
                self.mgr.save(i + 1, state)
        self.mgr.wait()
        return state

    def run(self) -> Any:
        while True:
            state, start = self._restore_or_init()
            try:
                return self._run_from(state, start)
            except KeyboardInterrupt:
                raise
            except Exception as e:                      # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.cfg.max_restarts} restarts") from e
                # on a cluster this is where the replacement pod spins up;
                # in-process we simply loop back to restore.
                continue
