"""DRAMPower-style DDR5 energy model (paper Fig. 10's read/activation split).

Energy per command from IDD-class currents × VDD × duration, folded into
per-event constants (pJ).  Values derive from DDR5-4800 datasheet-class
numbers (VDD = 1.1 V) as used by DRAMSim3's energy reporting:

  ACT+PRE pair    ~ (IDD0 - IDD3N) window          ≈ 160 pJ / activate
  RD burst        ~ (IDD4R - IDD3N) × tBL           ≈ 1.3 pJ/bit moved
  WR burst        ~ (IDD4W - IDD3N) × tBL           ≈ 1.4 pJ/bit
  background      ~ IDD3N standby per busy cycle    ≈ 55 mW/device

The absolute constants matter less than the *structure*: read energy scales
with bytes moved, activation energy with row-misses — which is exactly what
the bit-plane layout changes (fewer bytes, more sequential rows).
"""

from __future__ import annotations

import dataclasses

from repro_torch.memsim.dram import DramSystem


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    act_pre_pj: float = 160.0  # per activate(+precharge)
    rd_pj_per_bit: float = 1.3
    wr_pj_per_bit: float = 1.4
    standby_mw_per_device: float = 55.0
    n_devices: int = 40  # 4 channels × 10 ×4 devices


class EnergyModel:
    def __init__(self, params: EnergyParams | None = None):
        self.p = params or EnergyParams()

    def energy_uj(self, system: DramSystem, elapsed_ns: float) -> dict:
        s = system.stats()
        burst_bits = system.cfg.burst_bytes * 8
        rd = s["reads"] * burst_bits * self.p.rd_pj_per_bit
        wr = s["writes"] * burst_bits * self.p.wr_pj_per_bit
        act = s["acts"] * self.p.act_pre_pj
        standby = (
            self.p.standby_mw_per_device * self.p.n_devices * elapsed_ns * 1e-9
        ) * 1e3  # mW × s -> uJ... (mW*ns = pJ; convert below)
        standby = self.p.standby_mw_per_device * self.p.n_devices * elapsed_ns * 1e-3  # pJ
        total_pj = rd + wr + act + standby
        return {
            "read_uj": rd / 1e6,
            "write_uj": wr / 1e6,
            "activate_uj": act / 1e6,
            "standby_uj": standby / 1e6,
            "total_uj": total_pj / 1e6,
        }
