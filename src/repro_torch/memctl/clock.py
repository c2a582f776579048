"""Engine clock: scheduler steps -> (de)compression-engine cycles.

The serving scheduler advances in *steps* (one batched decode each); the
modeled silicon advances in *cycles* at ``clock_ghz``.  ``EngineClock`` pins
the two together: every scheduler step opens a window of ``step_cycles``
engine cycles, jobs are stamped with the cycle their last block drains from
the lane pool, and the gap between a step's window and the cycle its jobs
actually finished is the engine-limited latency the infinite-bandwidth
accounting used to hide.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class EngineClock:
    """Cycle counter with a per-step service window.

    ``step_cycles=None`` models an unbounded engine (the pre-memctl
    accounting): windows are infinitely wide, jobs complete the cycle they
    are submitted, and the modeled latency collapses to zero.
    """

    clock_ghz: float = 2.0
    step_cycles: int | None = 4096
    #: cycle the current step window opened at
    step_start: int = 0
    #: cycle of the latest serviced work (monotone; stamps AccessEvents)
    now: int = 0
    steps: int = 0

    @property
    def unbounded(self) -> bool:
        return self.step_cycles is None

    def advance_step(self) -> int:
        """Open the next step window; returns its starting cycle.

        ``now`` is deliberately NOT lifted to the new window: it tracks the
        cycle the last serviced work drained (lane completions are already
        >= the window start), so ``now`` stays a load-sensitive measure of
        engine-limited time while ``step_start`` tracks wall steps."""
        self.steps += 1
        if not self.unbounded:
            self.step_start += self.step_cycles
        return self.step_start

    def stamp(self, cycle: int | float) -> int:
        """Record work finishing at ``cycle``; keeps ``now`` monotone."""
        self.now = max(self.now, int(math.ceil(cycle)))
        return self.now

    # ------------------------------------------------------------ conversions
    def cycles_to_ns(self, cycles: float) -> float:
        return cycles / self.clock_ghz

    @property
    def elapsed_ns(self) -> float:
        return self.cycles_to_ns(self.now)

    def step_overhang_cycles(self) -> int:
        """Cycles the serviced work runs past the current step window — the
        engine-limited latency added to this step."""
        if self.unbounded:
            return 0
        return max(0, self.now - (self.step_start + self.step_cycles))
