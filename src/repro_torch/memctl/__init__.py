"""Memory-controller runtime: finite-throughput (de)compression engine.

The paper's on-chip engine — 32 lanes x 512 Gb/s (Table IV) — as a
cycle-approximate runtime the serving stack schedules against, instead of
compressing inline and unbounded per step.  See :mod:`repro_torch.memctl.runtime`
for the servicing semantics.
"""

from repro_torch.memctl.clock import EngineClock  # noqa: F401
from repro_torch.memctl.lanes import LanePool, MemCtlConfig  # noqa: F401
from repro_torch.memctl.queue import Job, JobClass, PriorityJobQueue  # noqa: F401
from repro_torch.memctl.runtime import CompressionEngineRuntime  # noqa: F401
from repro_torch.memctl.stats import EngineStats  # noqa: F401
