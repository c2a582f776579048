"""Serving engine: a thin facade over the continuous-batching scheduler.

    eng = ServingEngine(model, params, EngineConfig(...))   # CUDA by default
    eng.scheduler.submit(Request(...))   # any time, any step
    eng.scheduler.step()                 # admit -> decode -> retire
    eng.report()                         # steady-state accounting

``run()`` keeps the reference's one-shot call shape: submit a batch and
drain the scheduler.
"""

from __future__ import annotations

from typing import List

from repro_torch.serving.scheduler import ContinuousScheduler, EngineConfig, Request

__all__ = ["EngineConfig", "Request", "ServingEngine"]


class ServingEngine:
    """One scheduler, plus the one-shot ``run()`` path."""

    def __init__(self, model, params, cfg: EngineConfig, device=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.scheduler = ContinuousScheduler(model, params, cfg, device=device)

    @property
    def stats(self):
        return self.scheduler.stats

    def run(self, reqs: List[Request],
            rng_seed: int | None = None) -> List[Request]:
        """Submit a batch and drain the scheduler; returns the requests in
        input order, all done.  An explicit ``rng_seed`` re-seeds every
        request's sampling stream."""
        if len(reqs) > self.cfg.max_batch:
            raise ValueError(f"{len(reqs)} requests exceed max_batch {self.cfg.max_batch}")
        for r in reqs:
            self.scheduler.submit(r, rng_seed=rng_seed)
        self.scheduler.run_until_drained()
        return reqs

    def report(self) -> dict:
        return self.scheduler.report()
