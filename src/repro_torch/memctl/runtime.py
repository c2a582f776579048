"""Finite-throughput (de)compression engine runtime.

``CompressionEngineRuntime`` is the layer between the compression codecs and
the serving scheduler: callers *submit* jobs (decode fetches, KV page
writes, background re-compression) instead of compressing inline, and one
``tick()`` per scheduler step services the queue in strict priority order
against the lane pool's per-step byte budget.  Whatever doesn't fit the
window stays queued — deferred work is counted, queue depth is sampled, and
the clock records how far the modeled silicon runs behind the scheduler, so
``report()`` quotes engine-limited numbers instead of the infinite-bandwidth
accounting the scheduler used to assume.

Unbounded mode (``MemCtlConfig(step_cycles=None)``) reproduces that old
accounting through the same API — every job is serviced the tick it is
queued, with zero modeled latency — which is what the engine-utilization
benchmark compares against.
"""

# accounting-taint is suppressed line by line below: this module is the
# port's counterpart of repro/memctl/, which the rule's allow-list exempts.

from __future__ import annotations

import math

from repro_torch.memctl.clock import EngineClock
from repro_torch.memctl.lanes import LanePool, MemCtlConfig
from repro_torch.memctl.queue import Job, JobClass, PriorityJobQueue
from repro_torch.memctl.stats import EngineStats, _percentile
from repro_torch.telemetry.collector import NULL_COLLECTOR


class CompressionEngineRuntime:
    """Priority queue + lane pool + step clock, one tick per scheduler step.

    ``telemetry`` (a :mod:`repro_torch.telemetry` collector) records one
    structured event per tick (serviced bytes, queue depth, deferrals) and
    — through the lane pool — per-lane busy intervals, keyed by ``tier``
    (the owning shard's index).  The default null collector keeps every
    site a single-branch no-op."""

    def __init__(self, cfg: MemCtlConfig | None = None,
                 telemetry=None, tier: int = 0):
        self.cfg = cfg or MemCtlConfig()
        if self.cfg.step_cycles is not None and self.cfg.step_cycles < 1:
            raise ValueError("step_cycles must be >= 1 (or None for unbounded)")
        self.telemetry = telemetry if telemetry is not None else NULL_COLLECTOR
        self.tier = tier
        self.clock = EngineClock(self.cfg.clock_ghz, self.cfg.step_cycles)
        self.lanes = LanePool(
            self.cfg,
            on_block=(self.telemetry.on_lane_block
                      if self.telemetry.enabled else None),
            tier=tier,
        )
        self.queue = PriorityJobQueue()
        self.stats = EngineStats()

    # ------------------------------------------------------------- submission
    def submit(self, job: Job) -> Job:
        job.nbytes = max(0, int(job.nbytes))
        job.remaining = job.nbytes
        job.submit_step = self.clock.steps
        job.submit_cycle = self.clock.step_start
        self.queue.push(job)
        return job

    def submit_eviction(self, key, stored_bytes: int,
                        seq_id: int | None = None) -> Job:
        """Budget eviction write-back: the engine streams the victim's
        compressed bytes out to the capacity tier.  Occupancy only — the
        controller charges no bus event for a drop; the re-compress is
        charged if the page ever returns."""
        if self.telemetry.enabled:
            self.telemetry.on_eviction(self.tier, int(stored_bytes))
        return self.submit(Job(JobClass.BACKGROUND, stored_bytes,
                               fn=None, key=("evict",) + tuple(key)
                               if isinstance(key, tuple) else ("evict", key),
                               seq_id=seq_id))

    def pending(self, key, klass: JobClass | None = None) -> bool:
        return self.queue.pending(key, klass)

    def cancel_seq(self, seq_id) -> int:
        """Cancel queued jobs by cancellation scope (exact match — sharded
        backends scope with ``(shard, rid)`` tuples, see queue.cancel_seq)."""
        n = self.queue.cancel_seq(seq_id)
        self.stats.cancelled_jobs += n  # repro-lint: disable=accounting-taint
        return n

    def pressure_ns(self) -> float:
        """Modeled engine latency a newly admitted request would see right
        now: the time the lane pool needs to drain the queued backlog
        (``queue.remaining_bytes`` at the aggregate lane rate) plus how far
        the service clock already runs past the current window's start.
        Zero for an unbounded engine or an engine that keeps up — the
        admission-backpressure signal the scheduler consults against
        ``EngineConfig.admit_latency_ns_max``."""
        if self.clock.unbounded:
            return 0.0
        drain_cycles = (self.queue.remaining_bytes()
                        / (self.cfg.lanes * self.cfg.lane_bytes_per_cycle))
        lag = max(0, self.clock.now - self.clock.step_start)
        return self.clock.cycles_to_ns(lag + drain_cycles)

    # -------------------------------------------------------------- servicing
    def tick(self) -> dict:
        """Service one scheduler step's window; returns the step summary.

        Strict priority (fetch > write > background), FIFO within a class.
        A job bigger than the remaining budget is serviced partially and
        carried over — per-step serviced bytes never exceed the budget."""
        budget = self.cfg.step_budget_bytes
        spent = 0
        serviced = 0
        while True:
            job = self.queue.peek()
            if job is None:
                break
            if job.size_fn is not None:
                # deferred sizing: resolve bytes (and any caller-side
                # context, e.g. the ladder plane count) exactly once, the
                # moment service begins
                job.nbytes = job.remaining = max(0, int(job.size_fn()))
                job.size_fn = None
            take = job.remaining
            if not math.isinf(budget):
                take = min(take, int(budget - spent))
                if take <= 0 < job.remaining:
                    break  # window exhausted; job carries over
            if take > 0:
                if self.clock.unbounded:
                    done = self.clock.now  # infinite engine: no lane time
                else:
                    done = self.lanes.schedule(take, self.clock.step_start)
                job.remaining -= take
                spent += take
            if job.remaining > 0:
                continue  # partially serviced; retry within this window
            self.queue.pop()
            if take > 0:
                self.clock.stamp(done)
            if job.fn is not None:
                job.fn()
            self.stats.note_serviced(job.klass, job.nbytes)  # repro-lint: disable=accounting-taint
            serviced += 1
        deferred = self.queue.mark_deferred()
        overhang = self.clock.step_overhang_cycles()
        self.stats.close_step(spent, len(self.queue), deferred, overhang)  # repro-lint: disable=accounting-taint
        summary = {
            "serviced_jobs": serviced,
            "serviced_bytes": spent,
            "deferred_jobs": deferred,
            "queue_depth": len(self.queue),
            "overhang_cycles": overhang,
        }
        if self.telemetry.enabled:
            self.telemetry.on_engine_step(self.tier, {
                "step": self.stats.steps,
                "window_start_cycle": self.clock.step_start,
                **summary,
            })
        self.clock.advance_step()
        return summary

    # -------------------------------------------------------------- reporting
    def report(self) -> dict:
        r = self.stats.report()
        elapsed = max(self.clock.step_start, self.clock.now)
        lag_cycles = self.stats.step_overhang_cycles
        r.update({
            "lanes": self.cfg.lanes,
            "clock_ghz": self.cfg.clock_ghz,
            "block_bits": self.cfg.block_bits,
            "unbounded": self.clock.unbounded,
            "step_budget_bytes": (None if math.isinf(self.cfg.step_budget_bytes)
                                  else int(self.cfg.step_budget_bytes)),
            "utilization": self.lanes.utilization(elapsed),
            "elapsed_cycles": elapsed,
            # headline: engine time to service the run's traffic — the cycle
            # the last job drained from the lanes (NOT wall steps x window,
            # which would be identical for an idle and a saturated engine)
            "modeled_latency_ns": self.clock.cycles_to_ns(self.clock.now),
            # final backlog lag + how far behind the engine sat on average
            "lag_ns": self.clock.cycles_to_ns(lag_cycles[-1]) if lag_cycles else 0.0,
            "mean_step_lag_ns": (self.clock.cycles_to_ns(
                sum(lag_cycles) / len(lag_cycles)) if lag_cycles else 0.0),
            "silicon": self.cfg.silicon_cost(),
            # raw per-step samples so sharded aggregation can pool depths
            # across shards instead of max-ing pre-computed percentiles
            "step_queue_depth": list(self.stats.step_queue_depth),
        })
        return r


def aggregate_engine_reports(reports: list) -> dict:
    """Fleet view over per-shard engine reports (ShardedBackend's report()).

    Capacity-like quantities (serviced jobs/bytes, deferred work, lanes,
    budgets, silicon area/power) SUM across shards; latency-like quantities
    (modeled latency, lag) take the WORST shard — a request is only as fast
    as its slowest shard's fetches; utilization averages lane-weighted.
    Queue depth is pooled: per-step depths are summed across shards (the
    fleet's total backlog at each step) and the percentiles re-computed over
    the pooled series, so the aggregate p99 reflects simultaneous backlog
    instead of max-ing each shard's independently-computed percentiles
    (which both overstates skewed-load fleets and loses the fleet total).
    Reports without raw ``step_queue_depth`` samples fall back to the old
    max-of-percentiles.  A single report passes through unchanged upstream
    (the caller skips aggregation for one tier), so paged numbers are
    untouched.
    """
    assert reports, "aggregate_engine_reports needs at least one report"
    classes = reports[0]["serviced_jobs"].keys()
    lanes = sum(r["lanes"] for r in reports)
    samples = [r.get("step_queue_depth") for r in reports]
    if all(isinstance(s, list) for s in samples):
        n_steps = max((len(s) for s in samples), default=0)
        pooled = [sum(s[i] if i < len(s) else 0 for s in samples)
                  for i in range(n_steps)]
        depths = sorted(pooled)
        queue_depth = {
            "p50": _percentile(depths, 0.50),
            "p90": _percentile(depths, 0.90),
            "p99": _percentile(depths, 0.99),
            "max": float(depths[-1]) if depths else 0.0,
        }
    else:
        pooled = None
        queue_depth = {q: max(r["queue_depth"][q] for r in reports)
                       for q in reports[0]["queue_depth"]}
    budgets = [r["step_budget_bytes"] for r in reports]
    silicon: dict = {}
    for r in reports:
        for k, v in r["silicon"].items():
            silicon[k] = (silicon.get(k, 0) + v
                          if isinstance(v, (int, float)) else v)
    return {
        "shards": len(reports),
        "serviced_jobs": {c: sum(r["serviced_jobs"][c] for r in reports)
                          for c in classes},
        "serviced_bytes": {c: sum(r["serviced_bytes"][c] for r in reports)
                           for c in classes},
        "total_serviced_jobs": sum(r["total_serviced_jobs"] for r in reports),
        "total_serviced_bytes": sum(r["total_serviced_bytes"] for r in reports),
        "deferred_job_steps": sum(r["deferred_job_steps"] for r in reports),
        "cancelled_jobs": sum(r["cancelled_jobs"] for r in reports),
        "steps": max(r["steps"] for r in reports),
        "peak_step_serviced_bytes": max(r["peak_step_serviced_bytes"]
                                        for r in reports),
        "queue_depth": queue_depth,
        "step_queue_depth": pooled,
        "lanes": lanes,
        "clock_ghz": reports[0]["clock_ghz"],
        "block_bits": reports[0]["block_bits"],
        "unbounded": all(r["unbounded"] for r in reports),
        "step_budget_bytes": (None if any(b is None for b in budgets)
                              else sum(budgets)),
        "utilization": (sum(r["utilization"] * r["lanes"] for r in reports)
                        / max(1, lanes)),
        "elapsed_cycles": max(r["elapsed_cycles"] for r in reports),
        "modeled_latency_ns": max(r["modeled_latency_ns"] for r in reports),
        "lag_ns": max(r["lag_ns"] for r in reports),
        "mean_step_lag_ns": max(r["mean_step_lag_ns"] for r in reports),
        "silicon": silicon,
    }
