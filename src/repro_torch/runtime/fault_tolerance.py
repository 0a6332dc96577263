"""Fault tolerance for long runs (port of
``repro/runtime/fault_tolerance.py``; plain Python).

  HeartbeatRegistry  per-host liveness: a host whose last beat is older
                     than ``timeout_s`` is dead.
  StragglerDetector  per-host step times: an EWMA a host, flagged above the
                     fleet's mean + k sigma.
  TrainSupervisor    the restart loop: run steps, checkpoint every
                     ``save_every``, and on a ``HostFailure`` restore the
                     last committed checkpoint and go on from its step
                     (batches are a pure function of the step, so the
                     stream resumes exactly).

On a training mesh every rank runs the loop: a failure is taken on every
rank at the same step, and the manager's ``wait`` (a barrier after the
commit) and ``latest_step`` (the writer's answer, broadcast) make every
rank restore the same committed step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Callable


class HostFailure(RuntimeError):
    """Raised (or simulated) when a host dies mid-step."""


@dataclasses.dataclass
class HeartbeatRegistry:
    timeout_s: float = 60.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: float | None = None):
        self._last[host] = now if now is not None else time.time()

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def healthy(self, now: float | None = None) -> bool:
        return not self.dead_hosts(now)


class StragglerDetector:
    """Flags hosts whose step time exceeds mean + k*std of the fleet EWMA."""

    def __init__(self, alpha: float = 0.2, k_sigma: float = 3.0,
                 min_steps: int = 5):
        self.alpha = alpha
        self.k = k_sigma
        self.min_steps = min_steps
        self.ewma: dict[int, float] = {}
        self.count: dict[int, int] = defaultdict(int)

    def record(self, host: int, step_time_s: float):
        prev = self.ewma.get(host, step_time_s)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s
        self.count[host] += 1

    def stragglers(self) -> list[int]:
        ready = {h: v for h, v in self.ewma.items()
                 if self.count[h] >= self.min_steps}
        if len(ready) < 2:
            return []
        vals = list(ready.values())
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        thr = mean + self.k * math.sqrt(var)
        return [h for h, v in ready.items() if v > thr]


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    restored_steps: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)


class TrainSupervisor:
    """Restart-from-checkpoint loop around a step function.

    ``step_fn(state, step_idx) -> (state, metrics)`` may raise
    ``HostFailure``; ``make_state(restored_or_none)`` (re)builds the state
    from a restored tree (fresh when None).  A run that finds a committed
    checkpoint starts from it."""

    def __init__(self, ckpt_manager, save_every: int = 10,
                 max_restarts: int = 8):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_restarts = max_restarts

    def run(self, make_state: Callable, step_fn: Callable, total_steps: int,
            cfg=None) -> SupervisorReport:
        rep = SupervisorReport()
        restarts = 0
        state = make_state(None)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            restored, _ = self.ckpt.restore(state)
            state = make_state(restored)
            start = latest
            rep.restored_steps.append(latest)

        step = start
        while step < total_steps:
            try:
                state, metrics = step_fn(state, step)
                rep.losses.append(float(metrics.get("loss", float("nan"))))
                step += 1
                rep.steps_run += 1
                if step % self.save_every == 0 or step == total_steps:
                    self.ckpt.save(step, state, cfg=cfg, blocking=False)
            except HostFailure:
                restarts += 1
                rep.restarts = restarts
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:          # nothing committed yet
                    state = make_state(None)
                    step = 0
                else:
                    restored, _ = self.ckpt.restore(state)
                    state = make_state(restored)
                    step = latest
                    rep.restored_steps.append(latest)
        self.ckpt.wait()
        return rep
