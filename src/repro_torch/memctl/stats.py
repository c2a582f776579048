"""Runtime counters: serviced/deferred work, queue depth, utilization.

Everything the acceptance criteria ask ``ContinuousScheduler.report()`` to
quote lives here: per-class serviced/deferred/cancelled job counts, per-step
serviced bytes (never above the lane budget), queue-depth percentiles, lane
utilization, and the engine-limited latency the clock accumulates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.memctl.queue import JobClass


def _percentile(sorted_vals: List[int], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


@dataclasses.dataclass
class EngineStats:
    serviced_jobs: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k.name: 0 for k in JobClass}
    )
    serviced_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k.name: 0 for k in JobClass}
    )
    deferred_job_steps: int = 0  # job x step-boundary deferral events
    cancelled_jobs: int = 0
    steps: int = 0
    #: serviced logical bytes per step (the budget invariant's witness)
    step_serviced_bytes: List[int] = dataclasses.field(default_factory=list)
    #: queue depth sampled at each step-window close
    step_queue_depth: List[int] = dataclasses.field(default_factory=list)
    #: engine cycles the serviced work overran each step window by
    step_overhang_cycles: List[int] = dataclasses.field(default_factory=list)

    def note_serviced(self, klass: JobClass, nbytes: int) -> None:
        self.serviced_jobs[klass.name] += 1
        self.serviced_bytes[klass.name] += nbytes

    def close_step(self, serviced_bytes: int, queue_depth: int,
                   deferred: int, overhang_cycles: int) -> None:
        self.steps += 1
        self.step_serviced_bytes.append(serviced_bytes)
        self.step_queue_depth.append(queue_depth)
        self.step_overhang_cycles.append(overhang_cycles)
        self.deferred_job_steps += deferred

    # -------------------------------------------------------------- reporting
    def queue_depth_percentiles(self) -> dict:
        depths = sorted(self.step_queue_depth)
        return {
            "p50": _percentile(depths, 0.50),
            "p90": _percentile(depths, 0.90),
            "p99": _percentile(depths, 0.99),
            "max": float(depths[-1]) if depths else 0.0,
        }

    def report(self) -> dict:
        total_jobs = sum(self.serviced_jobs.values())
        total_bytes = sum(self.serviced_bytes.values())
        return {
            "serviced_jobs": dict(self.serviced_jobs),
            "serviced_bytes": dict(self.serviced_bytes),
            "total_serviced_jobs": total_jobs,
            "total_serviced_bytes": total_bytes,
            "deferred_job_steps": self.deferred_job_steps,
            "cancelled_jobs": self.cancelled_jobs,
            "steps": self.steps,
            "peak_step_serviced_bytes": max(self.step_serviced_bytes, default=0),
            "queue_depth": self.queue_depth_percentiles(),
        }
