"""Lane pool: the paper's 32 x 512 Gb/s (de)compression lanes as a timing
model.

Geometry and rates are calibrated from
:class:`repro_torch.memsim.hardware.CompressionEngineModel` (Table IV): each lane
sustains ``LANE_THROUGHPUT_GBPS`` on its decompressed side, so at
``clock_ghz`` a lane moves ``512 / 8 / clock_ghz`` bytes per cycle.  Work
arrives as jobs of logical (decompressed-side) bytes; a job is split into
``block_bytes`` chunks (the per-lane SRAM block buffer, ``block_bits / 8``)
and each chunk occupies the earliest-free lane for its cycle cost — the
same block-granular striping the silicon does.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.memsim.hardware import CompressionEngineModel


@dataclasses.dataclass(frozen=True)
class MemCtlConfig:
    """Engine geometry for the runtime (mirrors Table IV's knobs)."""

    #: 'lz4' | 'zstd' — which synthesized lane design; None follows the
    #: serving stack's codec choice (EngineConfig.codec / default_codec)
    engine: str | None = None
    lanes: int = 32
    clock_ghz: float = 2.0
    block_bits: int = 32768  # per-lane block buffer (16/32/64 Kb)
    #: engine cycles available per scheduler step; None = unbounded engine
    #: (the pre-memctl infinite-bandwidth accounting)
    step_cycles: int | None = 4096

    @property
    def lane_bytes_per_cycle(self) -> float:
        return self.hardware_model().lane_bytes_per_cycle()

    @property
    def block_bytes(self) -> int:
        return self.block_bits // 8

    @property
    def step_budget_bytes(self) -> float:
        """Aggregate bytes all lanes can move inside one step window."""
        if self.step_cycles is None:
            return math.inf
        return self.lanes * self.lane_bytes_per_cycle * self.step_cycles

    def hardware_model(self) -> CompressionEngineModel:
        return CompressionEngineModel(
            self.engine or "lz4", clock_ghz=self.clock_ghz, lanes=self.lanes
        )

    def silicon_cost(self) -> dict:
        """Area/power/throughput of this geometry (Table IV model)."""
        return self.hardware_model().total(self.block_bits)


class LanePool:
    """Earliest-free-lane block scheduler with per-lane busy accounting.

    ``on_block(tier, lane, start_cycle, end_cycle, nbytes)`` — when set —
    is invoked once per scheduled block chunk; the telemetry layer uses it
    to build per-lane busy timelines for the Perfetto export."""

    def __init__(self, cfg: MemCtlConfig, on_block=None, tier: int = 0):
        self.cfg = cfg
        self.on_block = on_block
        self.tier = tier
        # frozen config -> constant; avoid rebuilding the hardware model
        # for every scheduled block
        self._bytes_per_cycle = cfg.lane_bytes_per_cycle
        self._free_at = [0] * cfg.lanes  # cycle each lane next idles
        self.busy_cycles = [0] * cfg.lanes
        self.blocks_scheduled = 0

    def _block_cycles(self, nbytes: int) -> int:
        return max(1, math.ceil(nbytes / self._bytes_per_cycle))

    def schedule(self, nbytes: int, not_before: int) -> int:
        """Stripe ``nbytes`` across lanes in block_bytes chunks starting no
        earlier than cycle ``not_before``; returns the completion cycle of
        the last chunk."""
        if nbytes <= 0:
            return not_before
        done = not_before
        block = self.cfg.block_bytes
        for off in range(0, nbytes, block):
            chunk = min(block, nbytes - off)
            lane = min(range(self.cfg.lanes), key=self._free_at.__getitem__)
            start = max(not_before, self._free_at[lane])
            cycles = self._block_cycles(chunk)
            self._free_at[lane] = start + cycles
            self.busy_cycles[lane] += cycles
            self.blocks_scheduled += 1
            done = max(done, self._free_at[lane])
            if self.on_block is not None:
                self.on_block(self.tier, lane, start, start + cycles, chunk)
        return done

    def drain_cycle(self) -> int:
        """Cycle the last scheduled block finishes."""
        return max(self._free_at)

    def utilization(self, elapsed_cycles: int) -> float:
        """Busy fraction of lane-cycles over ``elapsed_cycles``."""
        if elapsed_cycles <= 0:
            return 0.0
        total = sum(self.busy_cycles)
        return min(1.0, total / (self.cfg.lanes * elapsed_cycles))
