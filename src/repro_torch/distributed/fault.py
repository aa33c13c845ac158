"""Fault tolerance for the training launcher (a copy of
``repro.distributed.fault``, which imports no JAX; the port keeps its
own).

* **Checkpoint/restart**: atomic checkpoints every ``save_every`` steps
  (``repro_torch.checkpoint.store``); on a step failure the supervisor
  restores the latest one and resumes.  The data order is a pure
  function of the step counter (``repro_torch.data.synthetic``), so a
  restart replays no batch and skips none.
* **Failure injection**: ``FailureInjector`` raises at configured steps
  (a dead host); the supervisor's retry loop runs the restart path.
* **Straggler watchdog**: a running median of step times; steps slower
  than ``threshold ×`` the median are logged and counted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerWatchdog:
    threshold: float = 3.0
    _times: List[float] = field(default_factory=list)
    slow_steps: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float, log=print):
        self._times.append(dt)
        if len(self._times) < 5:
            return
        med = sorted(self._times[-50:])[len(self._times[-50:]) // 2]
        if dt > self.threshold * med:
            self.slow_steps.append(step)
            log(f"[straggler] step {step} took {dt*1e3:.1f}ms "
                f"(median {med*1e3:.1f}ms)")


class Supervisor:
    """Retry loop around a training step with checkpoint restore."""

    def __init__(self, restore_fn: Callable[[], int],
                 max_restarts: int = 3, log=print):
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.restarts = 0
        self.log = log

    def run(self, step_fn: Callable[[int], None], start: int, end: int):
        step = start
        while step < end:
            try:
                step_fn(step)
                step += 1
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.log(f"[fault] {e} — restoring from checkpoint "
                         f"(restart {self.restarts}/{self.max_restarts})")
                step = self.restore_fn()
        return step
