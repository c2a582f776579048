"""Fault tolerance for long training runs (port of the reference's
``runtime/fault_tolerance.py``).

* :class:`StragglerDetector` — per-host EWMA of step times; hosts whose
  EWMA exceeds ``threshold`` x the fleet median enter the exclusion list
  that feeds the elastic-restart path (checkpoints are whole tensors, so
  any device count can resume).
* :class:`TrainSupervisor` — wraps a step function with checkpoint cadence,
  failure capture and restart from the latest checkpoint.  A failure
  surfaces as an exception from the step call (a CUDA error is a
  ``RuntimeError`` in torch); the supervisor restores the last committed
  checkpoint, rewinds the data loader (its state is one integer) and
  continues — exactly-once batch delivery.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerDetector:
    n_hosts: int
    alpha: float = 0.1  # EWMA weight
    threshold: float = 2.0  # exclude when EWMA > threshold x fleet median
    warmup_steps: int = 5

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.counts = np.zeros(self.n_hosts, np.int64)

    def record(self, host: int, step_time_s: float) -> None:
        if self.counts[host] == 0:
            self.ewma[host] = step_time_s
        else:
            self.ewma[host] = self.alpha * step_time_s + (1 - self.alpha) * self.ewma[host]
        self.counts[host] += 1

    def exclusion_list(self) -> list:
        ready = self.counts >= self.warmup_steps
        if ready.sum() < max(2, self.n_hosts // 2):
            return []
        med = float(np.median(self.ewma[ready]))
        return [h for h in range(self.n_hosts)
                if ready[h] and self.ewma[h] > self.threshold * med]

    def healthy_hosts(self) -> list:
        bad = set(self.exclusion_list())
        return [h for h in range(self.n_hosts) if h not in bad]


class TrainSupervisor:
    """Run ``step_fn`` to ``total_steps`` with checkpoint and restart.

    step_fn(state, batch) -> (state, metrics); ``state`` is the whole
    training tree (params, optimiser state, anything of tensors).
    ``loader`` follows the :class:`~repro_torch.data.ShardedLoader`
    protocol (batch_at / state / restore)."""

    def __init__(self, step_fn: Callable, loader, ckpt: CheckpointManager,
                 max_restarts: int = 3, on_step: Optional[Callable] = None):
        self.step_fn = step_fn
        self.loader = loader
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.on_step = on_step
        self.restarts = 0
        self.detector = StragglerDetector(n_hosts=getattr(loader.cfg, "n_hosts", 1))

    def run(self, init_state, total_steps: int):
        state = init_state
        step = 0
        restored, extra, ck_step = self.ckpt.restore_latest(init_state)
        if restored is not None:
            state = restored
            self.loader.restore(extra["loader"])
            step = ck_step
        while step < total_steps:
            try:
                batch = self.loader.batch_at(step)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                self.detector.record(self.loader.host, time.time() - t0)
                step += 1
                self.loader.restore({"step": step})
                self.ckpt.maybe_save(step, state, {"loader": {"step": step}})
                if self.on_step:
                    self.on_step(step, metrics)
            except _RECOVERABLE as e:  # noqa: PERF203
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                restored, extra, ck_step = self.ckpt.restore_latest(init_state)
                if restored is None:
                    state, step = init_state, 0
                else:
                    state = restored
                    step = ck_step
                    self.loader.restore(extra["loader"])
                print(f"[supervisor] recovered from {type(e).__name__} at step {step}"
                      f" (restart {self.restarts}/{self.max_restarts})")
        return state, step


class SimulatedFailure(RuntimeError):
    """Injected by tests to exercise the restart path."""


_RECOVERABLE = (SimulatedFailure, RuntimeError)
