"""Fault-tolerant step loop: checkpoint/restart, straggler watchdog, elastic
restore.

A copy of the reference's ``runtime/fault.py`` over the port's ``obs``.

``FaultTolerantLoop`` wraps any step function.  Behaviour under failure:
  * a step raising ``StepFailure`` (or any exception matching
    ``recoverable``) triggers restore-from-latest-checkpoint and replay —
    the data pipeline is deterministic in the step number, so replay is
    exact;
  * repeated failures at the same step escalate after ``max_retries``;
  * a straggler watchdog tracks per-step wall time and reports hosts/steps
    exceeding ``straggler_factor`` x the rolling median (on a real cluster
    this feeds the controller that re-schedules the slow host; here it is
    surfaced through the ``repro_torch.obs`` metrics registry —
    ``fault.step_wall_s`` histogram, ``fault.last_step_wall_s`` /
    ``fault.step_median_s`` gauges, ``fault.straggler_events`` counter).

Checkpoints are layout-free (see checkpoint/), so a loop whose world
restarts on another mesh (say 2x2 -> 1x2) resumes there: its
``restore_fn`` restores with the new mesh's shardings
(``checkpoint.restore(shardings=, mesh=)``, as ``launch.train`` does),
every rank slicing its own shards, and the replay is exact.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Optional


class StepFailure(RuntimeError):
    """Raised by a step function to simulate/flag a recoverable failure."""


@dataclasses.dataclass
class LoopConfig:
    checkpoint_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 20


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    straggler_events: List[int] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)


class FaultTolerantLoop:
    def __init__(
        self,
        *,
        step_fn: Callable[[int, Any], Any],       # (step, state) -> state
        save_fn: Callable[[int, Any], None],      # checkpoint writer
        restore_fn: Callable[[], tuple],          # () -> (step, state)
        config: Optional[LoopConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        # None sentinel: a dataclass default instance here would be shared
        # by every loop ever constructed, so mutating one loop's config
        # (e.g. a test tightening straggler_factor) leaks into all others
        self.cfg = config if config is not None else LoopConfig()
        self.clock = clock
        self.report = LoopReport()

    def _watch(self, step: int, dt: float):
        from ..obs import counter, gauge, histogram

        times = self.report.step_times
        times.append(dt)
        gauge("fault.last_step_wall_s").set(dt)
        histogram("fault.step_wall_s").observe(dt)
        window = times[-self.cfg.straggler_window:]
        if len(window) >= 5:
            med = statistics.median(window[:-1])
            gauge("fault.step_median_s").set(med)
            if dt > self.cfg.straggler_factor * med:
                self.report.straggler_events.append(step)
                counter("fault.straggler_events").inc()

    def run(self, state: Any, start_step: int, num_steps: int) -> Any:
        step = start_step
        retries = 0
        end = start_step + num_steps
        while step < end:
            t0 = self.clock()
            try:
                state = self.step_fn(step, state)
            except StepFailure:
                self.report.failures += 1
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                step, state = self.restore_fn()
                self.report.restores += 1
                continue
            retries = 0
            self._watch(step, self.clock() - t0)
            self.report.steps_run += 1
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.save_fn(step, state)
        self.save_fn(step, state)
        return state
