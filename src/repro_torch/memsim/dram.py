"""DDR5-4800 bank-state timing model (DRAMSim3-lite).

Event-accurate rather than cycle-accurate (DESIGN.md §2): each bank tracks
its open row and the earliest cycle each command class may issue, honoring
the first-order JEDEC constraints that dominate LLM streaming traffic:

  tRCD  ACT -> internal READ/WRITE       39 cycles (16.25 ns @ 2400 MHz clk)
  CL    READ -> data                     40 cycles
  tRP   PRE -> ACT                       39 cycles
  tRAS  ACT -> PRE                       76 cycles
  tBL   burst = BL16 / 2 (DDR)            8 cycles
  tCCD_L/S same/other bank-group CAS gap  12 / 8 cycles
  tRRD_L/S ACT->ACT same/other bank group 12 / 8 cycles
  tFAW  four-activate window              32 cycles

Parameters follow DRAMSim3's DDR5_4800.ini values (the paper's simulator
config).  A channel interleaves addresses across bank groups at 256 B
granularity — the streaming-friendly mapping a memory controller uses for
large sequential weight/KV reads.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DDR5Config:
    name: str = "DDR5-4800"
    clk_ghz: float = 2.4  # command clock (data rate 4800 MT/s)
    bus_bits: int = 40  # 10 ×4 devices per channel (paper §IV.B)
    bl: int = 16
    n_bank_groups: int = 8
    banks_per_group: int = 4
    row_bytes: int = 1024  # per-device 1KB page × ... modeled per channel
    # timing in command-clock cycles (DRAMSim3 DDR5_4800.ini)
    tRCD: int = 39
    tCL: int = 40
    tRP: int = 39
    tRAS: int = 76
    tCCD_L: int = 12
    tCCD_S: int = 8
    tRRD_L: int = 12
    tRRD_S: int = 8
    tFAW: int = 32
    tWR: int = 72
    #: effective row-buffer span per bank (rank-wide: 10 ×4 devices share
    #: commands; 8 KB is the DDR5 x4 1KB-page × 8 devices-per-... rank page)
    effective_row_bytes: int = 8192

    @property
    def burst_cycles(self) -> int:
        return self.bl // 2

    @property
    def burst_bytes(self) -> int:
        # bus_bits wide, BL transfers on both edges
        return self.bus_bits * self.bl // 8

    @property
    def n_banks(self) -> int:
        return self.n_bank_groups * self.banks_per_group


@dataclasses.dataclass
class _Bank:
    open_row: int = -1
    ready_at: int = 0  # earliest cycle a new command may issue
    act_at: int = -10**9  # last ACT time (tRAS)


class DramChannel:
    """One DDR5 channel: banks × bank-groups with row-buffer state."""

    def __init__(self, cfg: DDR5Config):
        self.cfg = cfg
        self.banks = [_Bank() for _ in range(cfg.n_banks)]
        self.now = 0  # current cycle
        self.last_cas = -10**9
        self.last_cas_group = -1
        self.act_times: list = []  # recent ACTs for tFAW
        self.stats = {
            "reads": 0, "writes": 0, "acts": 0, "pres": 0,
            "row_hits": 0, "row_misses": 0, "cycles_busy": 0,
        }

    # ------------------------------------------------------------------
    def _addr_map(self, addr: int):
        """Burst-granular bank-group interleave (streaming-friendly mapping:
        consecutive bursts rotate bank groups, so the tCCD_S=8 gap exactly
        matches the 8-cycle burst and sequential reads run gapless)."""
        cfg = self.cfg
        blk = addr // cfg.burst_bytes
        bg = blk % cfg.n_bank_groups
        bank = (blk // cfg.n_bank_groups) % cfg.banks_per_group
        row = addr // (cfg.effective_row_bytes * cfg.n_banks)
        return bg, bank, row

    def _issue_act(self, bank: _Bank, row: int, t: int) -> int:
        cfg = self.cfg
        # tFAW: at most 4 ACTs in any tFAW window
        self.act_times = [a for a in self.act_times if a > t - cfg.tFAW]
        if len(self.act_times) >= 4:
            t = max(t, self.act_times[-4] + cfg.tFAW)
        self.act_times.append(t)
        bank.open_row = row
        bank.act_at = t
        self.stats["acts"] += 1
        return t

    def access(self, addr: int, nbytes: int, is_write: bool = False) -> int:
        """Stream ``nbytes`` starting at ``addr``; returns completion cycle.

        Large sequential transfers (≥ 4 MB) take an analytic fast path with
        identical steady-state behaviour (burst-interleaved gapless data,
        one ACT per row window, pipeline-fill latency once): the per-burst
        event loop is reserved for small/random traffic where bank-state
        details matter."""
        if nbytes >= (4 << 20):
            return self._access_streaming(addr, nbytes, is_write)
        cfg = self.cfg
        t_done = self.now
        offset = 0
        while offset < nbytes:
            bg, bank_idx, row = self._addr_map(addr + offset)
            bank = self.banks[bg * cfg.banks_per_group + bank_idx]
            t = max(self.now, bank.ready_at)
            if bank.open_row != row:
                if bank.open_row >= 0:  # precharge first
                    t = max(t, bank.act_at + cfg.tRAS)
                    t += cfg.tRP
                    self.stats["pres"] += 1
                t = self._issue_act(bank, row, t)
                t += cfg.tRCD
                self.stats["row_misses"] += 1
            else:
                self.stats["row_hits"] += 1
            # CAS spacing (bank-group aware)
            gap = cfg.tCCD_L if bg == self.last_cas_group else cfg.tCCD_S
            t = max(t, self.last_cas + gap)
            self.last_cas = t
            self.last_cas_group = bg
            data_done = t + (cfg.tWR if is_write else cfg.tCL) + cfg.burst_cycles
            bank.ready_at = t + cfg.tCCD_L
            self.stats["writes" if is_write else "reads"] += 1
            t_done = max(t_done, data_done)
            offset += cfg.burst_bytes
            self.now = t  # commands issue in order
        self.now = max(self.now, t_done - cfg.tCL)  # pipelined bursts overlap
        self.stats["cycles_busy"] = max(self.stats["cycles_busy"], t_done)
        return t_done

    def _access_streaming(self, addr: int, nbytes: int, is_write: bool) -> int:
        """Analytic steady-state model for long sequential streams."""
        cfg = self.cfg
        n_bursts = -(-nbytes // cfg.burst_bytes)
        window = cfg.effective_row_bytes * cfg.n_banks
        n_windows = -(-nbytes // window)
        n_acts = n_windows * cfg.n_banks
        # Pipeline fill once; bank-group-interleaved bursts stream gapless
        # (tCCD_S == burst length); ACTs of the next window overlap data of
        # the previous one (tFAW admits one ACT per 8 cycles, each row
        # buffers ~100 bursts of data).
        t = max(self.now, max(b.ready_at for b in self.banks))
        t += cfg.tRP + cfg.tRCD  # worst-case first-row open
        data_cycles = n_bursts * cfg.burst_cycles
        t_done = t + data_cycles + (cfg.tWR if is_write else cfg.tCL)
        for b in self.banks:
            b.ready_at = t_done - cfg.tCL
            b.open_row = -2  # unknown after bulk stream
        self.now = t_done - cfg.tCL
        self.last_cas = self.now
        self.stats["writes" if is_write else "reads"] += n_bursts
        self.stats["acts"] += n_acts
        self.stats["pres"] += max(0, n_acts - cfg.n_banks)
        self.stats["row_hits"] += n_bursts - n_acts
        self.stats["row_misses"] += n_acts
        self.stats["cycles_busy"] = max(self.stats["cycles_busy"], t_done)
        return t_done

    def ns(self, cycles: int) -> float:
        return cycles / self.cfg.clk_ghz


class DramSystem:
    """The paper's module: 4 channels, accesses striped round-robin at 4 KB."""

    def __init__(self, cfg: DDR5Config | None = None, n_channels: int = 4):
        self.cfg = cfg or DDR5Config()
        self.channels = [DramChannel(self.cfg) for _ in range(n_channels)]
        self._next_addr = [0] * n_channels

    def stream_access(self, nbytes: int, is_write: bool = False,
                      sequential: bool = True) -> float:
        """Stream an ``nbytes`` transfer striped over channels; returns the
        completion time in ns (max over channels — they run in parallel)."""
        n = len(self.channels)
        stripe = 4096
        per_chan = [0] * n
        full, rem = divmod(nbytes, stripe)
        for i in range(n):
            per_chan[i] = (full // n + (1 if i < full % n else 0)) * stripe
        per_chan[0] += rem
        done = 0
        for i, chan in enumerate(self.channels):
            if per_chan[i] == 0:
                continue
            addr = self._next_addr[i] if sequential else (self._next_addr[i] + 7919 * 4096)
            t = chan.access(addr, per_chan[i], is_write)
            self._next_addr[i] = addr + per_chan[i]
            done = max(done, chan.ns(t))
        return done

    @property
    def peak_bw_gbps(self) -> float:
        """Aggregate peak bandwidth (GB/s) for sanity checks."""
        c = self.cfg
        per_chan = c.bus_bits / 8 * c.clk_ghz * 2  # bytes/ns
        return per_chan * len(self.channels)

    def stats(self) -> dict:
        agg: dict = {}
        for ch in self.channels:
            for k, v in ch.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg
