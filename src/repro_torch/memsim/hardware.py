"""Silicon-cost model of the hardware (de)compression engines (Table IV).

The paper synthesizes LZ4 and ZSTD lanes at 2 GHz in ASAP7 and reports
area/power vs block size and 512 Gb/s per-lane throughput.  This module is
an analytic model CALIBRATED to those numbers (linear in block-buffer bits
plus a fixed match-engine core), used to (a) reproduce Table IV and (b)
sanity-check that a 32-lane engine keeps up with the serving path's
bandwidth demand (2 TB/s aggregate).
"""

from __future__ import annotations

import dataclasses

#: (engine, block_bits) -> (single-lane area mm², single-lane power mW)
#: — the paper's measured points (Table IV).
PAPER_POINTS = {
    ("lz4", 16384): (0.05669, 696.515),
    ("lz4", 32768): (0.07557, 885.258),
    ("lz4", 65536): (0.15106, 1640.233),
    ("zstd", 16384): (0.08357, 1363.715),
    ("zstd", 32768): (0.10245, 1552.458),
    ("zstd", 65536): (0.17794, 2307.433),
}

LANE_THROUGHPUT_GBPS = 512  # per lane, both engines (Table IV)


@dataclasses.dataclass(frozen=True)
class CompressionEngineModel:
    """Linear model: cost = core + buffer_coefficient × block_bits.

    Fitted per engine from the paper's three block sizes; the buffer term
    captures the SRAM block buffers (dominant at 64 Kb), the core term the
    match/entropy pipelines.
    """

    engine: str  # 'lz4' | 'zstd'
    clock_ghz: float = 2.0
    lanes: int = 32

    def _fit(self):
        pts = [(bb, PAPER_POINTS[(self.engine, bb)]) for bb in (16384, 32768, 65536)]
        # least-squares line through the three (block_bits, value) points
        def line(vals):
            xs = [p[0] for p in pts]
            n = len(xs)
            mx = sum(xs) / n
            my = sum(vals) / n
            num = sum((x - mx) * (y - my) for x, y in zip(xs, vals))
            den = sum((x - mx) ** 2 for x in xs)
            slope = num / den
            return my - slope * mx, slope

        areas = [v[1][0] for v in pts]
        powers = [v[1][1] for v in pts]
        return line(areas), line(powers)

    def single_lane(self, block_bits: int) -> dict:
        (a0, a1), (p0, p1) = self._fit()
        return {
            "area_mm2": a0 + a1 * block_bits,
            "power_mw": p0 + p1 * block_bits,
            "throughput_gbps": LANE_THROUGHPUT_GBPS,
        }

    def total(self, block_bits: int) -> dict:
        sl = self.single_lane(block_bits)
        return {
            "lanes": self.lanes,
            "area_mm2": sl["area_mm2"] * self.lanes,
            "power_mw": sl["power_mw"] * self.lanes
            + 0.2 * sl["power_mw"] * self.lanes * 0.0,  # no shared overhead term
            "throughput_gbps": sl["throughput_gbps"] * self.lanes,
            "throughput_tbs": sl["throughput_gbps"] * self.lanes / 8 / 1000,
        }

    def paper_total(self, block_bits: int) -> dict:
        """Exact Table IV row (for the benchmark's side-by-side check)."""
        a, p = PAPER_POINTS[(self.engine, block_bits)]
        # Paper's lane-total power is NOT 32×single-lane (shared dictionary/
        # scheduler amortization); reproduce the printed totals.
        paper_totals = {
            ("lz4", 16384): (1.81413, 2228.846),
            ("lz4", 32768): (2.41811, 2832.826),
            ("lz4", 65536): (4.83403, 5248.745),
            ("zstd", 16384): (2.67429, 4363.886),
            ("zstd", 32768): (3.27827, 4967.866),
            ("zstd", 65536): (5.69419, 7384.785),
        }
        ta, tp = paper_totals[(self.engine, block_bits)]
        return {
            "sl_area_mm2": a,
            "sl_power_mw": p,
            "tot_area_mm2": ta,
            "tot_power_mw": tp,
            "sl_thpt_gbps": LANE_THROUGHPUT_GBPS,
            "agg_thpt_tbs": LANE_THROUGHPUT_GBPS * self.lanes / 8 / 1000,
        }

    def sustains_bandwidth(self, demand_gbps: float, block_bits: int) -> bool:
        """Does the engine keep up with a given decompressed-side demand?"""
        return self.lanes * LANE_THROUGHPUT_GBPS / 8 >= demand_gbps

    def lane_bytes_per_cycle(self) -> float:
        """Decompressed-side bytes one lane moves per clock cycle — the
        calibration constant :mod:`repro_torch.memctl` schedules lane time with
        (512 Gb/s at 2 GHz = 32 B/cycle)."""
        return LANE_THROUGHPUT_GBPS / 8.0 / self.clock_ghz
