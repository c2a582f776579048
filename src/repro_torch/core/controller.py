"""Memory-controller model (paper Fig. 4).

``MemoryController`` is the host-side functional model of the enhanced
controller: it owns the weight store and the KV-page store, performs the
bit-plane/clustering transforms on writes, serves (possibly partial-precision)
reads, and logs every DRAM-side access so :mod:`repro_torch.memsim` can replay the
trace through the DDR5 timing/energy model.

Semantics knobs mirror the paper's hardware config: codec (LZ4/ZSTD), block
size (2/4 KB), bit-plane on/off (proposed vs. traditional), KV clustering and
de-correlation mode.
"""

# accounting-taint is suppressed line by line below: this module is the
# port's counterpart of repro/core/controller.py, which the rule's allow-list exempts.

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.bitplane import FloatSpec
from repro_torch.core.compressed_store import (
    CompressedTensor,
    StoreConfig,
    compress_kv,
    compress_weights,
    decompress_kv,
    decompress_weights,
)


@dataclasses.dataclass
class AccessEvent:
    """One controller<->DRAM transfer (after (de)compression)."""

    kind: str  # 'weight_read' | 'weight_write' | 'kv_read' | 'kv_write'
    name: str
    logical_bytes: int  # what the compute fabric asked for
    physical_bytes: int  # what actually moved on the DRAM bus
    planes: int | None = None  # precision fetched, if partial
    #: (de)compression-engine cycle the transfer was serviced at, stamped
    #: when a memctl EngineClock is attached; None = unmodeled/infinite engine
    cycle: int | None = None
    #: decompressed-side bytes at the fetched precision — planes/bits of the
    #: pad-free logical bytes.  This is what a bit-plane DEVICE cache moves
    #: on its own bus for the same access (the serving device path asserts
    #: its kernel-read bytes equal against this); defaults to logical_bytes
    #: for full-precision and write events
    device_bytes: int | None = None

    @property
    def device_side_bytes(self) -> int:
        return (self.logical_bytes if self.device_bytes is None
                else self.device_bytes)


@dataclasses.dataclass
class ControllerStats:
    """Access log + O(1) running totals.

    ``retain_events=False`` keeps only the totals — the serving scheduler
    logs one event per resident page per decode step, which would grow the
    list without bound on long runs; the DRAM-trace replay path needs the
    full event list and leaves retention on (the default)."""

    events: List[AccessEvent] = dataclasses.field(default_factory=list)
    retain_events: bool = True
    # kind -> [logical_bytes, physical_bytes, count, device_bytes]
    totals: Dict[str, list] = dataclasses.field(default_factory=dict)

    def log(self, ev: AccessEvent):
        t = self.totals.setdefault(ev.kind, [0, 0, 0, 0])
        t[0] += ev.logical_bytes
        t[1] += ev.physical_bytes
        t[2] += 1
        t[3] += ev.device_side_bytes
        if self.retain_events:
            self.events.append(ev)

    def kind_bytes(self, kind: str) -> tuple:
        """(logical, physical) running totals for one event kind."""
        t = self.totals.get(kind, (0, 0, 0, 0))
        return t[0], t[1]

    def kind_count(self, kind: str) -> int:
        """Number of logged events of one kind (per-tier charge counting —
        the backend conformance suite checks every kv_write charged once)."""
        return self.totals.get(kind, (0, 0, 0, 0))[2]

    def kind_device_bytes(self, kind: str) -> int:
        """Decompressed-side (plane-scaled) byte total for one event kind —
        the bytes a bit-plane device cache moves for the same accesses.
        The serving device path asserts its kernel-read accounting equal
        against ``kind_device_bytes('kv_read')``."""
        return self.totals.get(kind, (0, 0, 0, 0))[3]

    @property
    def logical_bytes(self) -> int:
        return sum(t[0] for t in self.totals.values())

    @property
    def physical_bytes(self) -> int:
        return sum(t[1] for t in self.totals.values())

    @property
    def bandwidth_saving(self) -> float:
        lb = self.logical_bytes
        return 1.0 - self.physical_bytes / lb if lb else 0.0

    def reads(self) -> List[AccessEvent]:
        return [e for e in self.events if e.kind.endswith("read")]


class MemoryController:
    """Functional model of the compression-aware controller."""

    def __init__(self, config: StoreConfig | None = None,
                 retain_events: bool = True):
        self.config = config or StoreConfig()
        self._weights: Dict[str, CompressedTensor] = {}
        self._kv_pages: Dict[tuple, CompressedTensor] = {}
        self.stats = ControllerStats(retain_events=retain_events)
        self._engine_clock = None  # memctl EngineClock, when serving attaches one

    def attach_engine_clock(self, clock) -> None:
        """Stamp every subsequent AccessEvent with the (de)compression
        engine's service cycle (memctl runtime runs job bookkeeping at
        modeled service time, so ``clock.now`` IS the service cycle)."""
        self._engine_clock = clock

    def _log(self, ev: AccessEvent) -> None:
        if self._engine_clock is not None:
            ev.cycle = self._engine_clock.now
        self.stats.log(ev)  # repro-lint: disable=accounting-taint

    # -------------------------------------------------------------- weights
    def write_weights(
        self, name: str, arr: np.ndarray, spec: FloatSpec,
        valid_values: int | None = None,
    ) -> CompressedTensor:
        """``valid_values`` marks how many leading elements of ``arr`` are
        real data when the weight store pads a tensor block to the lane
        stripe granularity — the event's logical bytes (and every later
        read) are quoted pad-free, mirroring ``write_kv_page``."""
        ct = compress_weights(arr, spec, self.config,
                              valid_values=valid_values)
        self._weights[name] = ct
        self._log(
            AccessEvent("weight_write", name, ct.valid_logical_bytes,
                        ct.stored_bytes)
        )
        return ct

    def _log_weight_read(self, name: str, planes: int | None) -> tuple:
        ct = self._weights[name]
        fetched = ct.fetch_bytes(planes)
        device = (ct.valid_logical_bytes if planes is None else
                  max(1, round(ct.valid_logical_bytes * planes / ct.spec.bits)))
        self._log(AccessEvent("weight_read", name, ct.valid_logical_bytes,
                              fetched, planes, device_bytes=device))
        return ct, fetched

    def read_weights(self, name: str, planes: int | None = None) -> np.ndarray:
        ct, _ = self._log_weight_read(name, planes)
        return decompress_weights(ct, planes)

    def account_weight_read(self, name: str, planes: int | None = None) -> int:
        """Log a weight read without decompressing (bandwidth modeling for
        the weight streamer: the lossless round-trip is pinned by tests, so
        steady-state streaming charges the bus/lane cost only).  Returns
        the physical bytes the bus would move."""
        return self._log_weight_read(name, planes)[1]

    def has_weights(self, name: str) -> bool:
        return name in self._weights

    def weight_tensor(self, name: str) -> CompressedTensor:
        return self._weights[name]

    # ------------------------------------------------------------------- KV
    def write_kv_page(
        self, key: tuple, kv: np.ndarray, spec: FloatSpec,
        valid_values: int | None = None,
    ) -> CompressedTensor:
        """key: (layer, head_group, page_index); kv: (tokens, channels).

        ``valid_values`` marks how many leading elements of ``kv`` are real
        data when a tail page arrives physically padded to the page size —
        the event's logical bytes (and every later read of this page) are
        quoted pad-free, so padding never inflates the savings ratios."""
        ct = compress_kv(kv, spec, self.config)
        ct.valid_values = valid_values
        self._kv_pages[key] = ct
        self._log(
            AccessEvent("kv_write", str(key), ct.valid_logical_bytes,
                        ct.stored_bytes)
        )
        return ct

    def _log_kv_read(self, key: tuple, planes: int | None) -> tuple:
        ct = self._kv_pages[key]
        fetched = ct.fetch_bytes(planes)
        # decompressed-side cost of the same fetch: planes/bits of the
        # pad-free page (the formula fetch_plan sizes engine jobs with)
        device = (ct.valid_logical_bytes if planes is None else
                  max(1, round(ct.valid_logical_bytes * planes / ct.spec.bits)))
        self._log(AccessEvent("kv_read", str(key), ct.valid_logical_bytes,
                              fetched, planes, device_bytes=device))
        return ct, fetched

    def read_kv_page(self, key: tuple, planes: int | None = None) -> np.ndarray:
        ct, _ = self._log_kv_read(key, planes)
        return decompress_kv(ct, planes)

    def account_kv_read(self, key: tuple, planes: int | None = None) -> int:
        """Log a KV page read without decompressing (bandwidth modeling for
        reads whose *values* are already resident in the device working set —
        the serving scheduler's steady-state decode fetches).  Returns the
        physical bytes the bus would move."""
        return self._log_kv_read(key, planes)[1]

    def has_kv_page(self, key: tuple) -> bool:
        return key in self._kv_pages

    def kv_page(self, key: tuple) -> CompressedTensor:
        return self._kv_pages[key]

    def drop_kv_page(self, key: tuple) -> CompressedTensor | None:
        """Remove a page (capacity eviction or sequence retirement).  No
        access event: dropping a compressed page moves no DRAM-bus bytes —
        the cost model charges the *re-write* if the page ever returns."""
        return self._kv_pages.pop(key, None)

    # ------------------------------------------------------------ accounting
    def footprint(self) -> dict:
        w = sum(ct.stored_bytes for ct in self._weights.values())
        wl = sum(ct.valid_logical_bytes for ct in self._weights.values())
        k = sum(ct.stored_bytes for ct in self._kv_pages.values())
        kl = sum(ct.valid_logical_bytes for ct in self._kv_pages.values())
        return {
            "weights_logical": wl,
            "weights_stored": w,
            "weights_saving": 1 - w / wl if wl else 0.0,
            "kv_logical": kl,
            "kv_stored": k,
            "kv_saving": 1 - k / kl if kl else 0.0,
        }

    def access_trace(self) -> List[AccessEvent]:
        """Events for the DRAM simulator (reads dominate inference traffic)."""
        return list(self.stats.events)
