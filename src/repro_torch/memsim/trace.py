"""Replay controller access traces through the DDR5 model.

Bridges :class:`repro_torch.core.controller.MemoryController` (functional model:
what bytes move, at which precision) and :mod:`repro_torch.memsim.dram` (when and
at what energy).  The paper's Fig. 10/11 pipeline is exactly this: model
inference produces a per-layer weight/KV access pattern; the proposed (P)
layout moves ``compressed + partial-plane`` bytes, the traditional (T)
layout moves raw bytes; both replay through DRAMSim3.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.controller import AccessEvent
from repro_torch.memsim.dram import DDR5Config, DramSystem
from repro_torch.memsim.energy import EnergyModel


@dataclasses.dataclass
class ReplayResult:
    elapsed_ns: float
    bytes_moved: int
    energy: dict
    dram_stats: dict
    #: time the (de)compression engine took to service the same events,
    #: from the memctl cycle stamps (0 when the trace carries no stamps —
    #: i.e. it was produced without an engine runtime attached)
    engine_elapsed_ns: float = 0.0

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_ns / 1e6

    @property
    def effective_gbps(self) -> float:
        return self.bytes_moved / max(self.elapsed_ns, 1e-9)

    @property
    def limited_elapsed_ns(self) -> float:
        """End-to-end latency under BOTH finite resources: the slower of the
        DRAM replay and the finite-throughput engine bounds the pipeline."""
        return max(self.elapsed_ns, self.engine_elapsed_ns)

    @property
    def engine_bound(self) -> bool:
        return self.engine_elapsed_ns > self.elapsed_ns


def replay_controller_trace(
    events: Iterable[AccessEvent],
    cfg: DDR5Config | None = None,
    n_channels: int = 4,
    reads_only: bool = True,
    engine_clock_ghz: float = 2.0,
) -> ReplayResult:
    """Replay ``events`` (physical_bytes per event) through a fresh DDR5
    system; returns latency/energy.  ``reads_only`` replays the load path
    (Fig. 11 measures model-load latency; writes happen once at deploy).

    Events stamped with a memctl engine cycle (``AccessEvent.cycle``) also
    yield ``engine_elapsed_ns`` — the finite-throughput engine's time to
    service the same traffic — so callers can quote engine-limited rather
    than infinite-bandwidth latency (``limited_elapsed_ns``).
    ``engine_clock_ghz`` MUST match the clock of the engine that stamped
    the trace (``MemCtlConfig.clock_ghz``, paper default 2 GHz) — the
    stamps are raw cycles and carry no rate of their own."""
    system = DramSystem(cfg, n_channels)
    total_bytes = 0
    t_end = 0.0
    last_cycle = 0
    for ev in events:
        if reads_only and not ev.kind.endswith("read"):
            continue
        if ev.cycle is not None:
            last_cycle = max(last_cycle, ev.cycle)
        nbytes = ev.physical_bytes
        if nbytes <= 0:
            continue
        t_end = system.stream_access(nbytes, is_write=ev.kind.endswith("write"))
        total_bytes += nbytes
    energy = EnergyModel().energy_uj(system, t_end)
    return ReplayResult(
        elapsed_ns=t_end,
        bytes_moved=total_bytes,
        energy=energy,
        dram_stats=system.stats(),
        engine_elapsed_ns=last_cycle / engine_clock_ghz,
    )


def synthetic_weight_trace(layer_bytes: list, kind: str = "weight_read"):
    """Layer-by-layer weight fetch trace (autoregressive decode reads every
    layer once per token)."""
    return [
        AccessEvent(kind, f"layer{i}", b, b) for i, b in enumerate(layer_bytes)
    ]
