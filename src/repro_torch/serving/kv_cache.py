"""Compressed paged KV store (paper §III.B at the serving layer).

Pages of 16 tokens (the paper's group / Quest's page) are compressed with
cross-token clustering + exponent delta + bit-planes + LZ4/ZSTD, and
charged through a :class:`~repro_torch.core.controller.MemoryController`.
The store runs host-side — the "capacity" half of the paper's claim; the
"bandwidth" half lives in the device path (the paged-attention kernels'
partial-plane reads).

* **Byte budget + LRU eviction.** ``max_stored_bytes`` caps the compressed
  footprint; when a put crosses the budget, least-recently-used pages are
  evicted (ground truth stays in the device working set, so an evicted
  page costs a re-compress *write* if it ever returns).
* **Ladder plane hints.** ``set_planes`` records the precision the
  dynamic quantization ladder assigned to a page; ``account_fetch``
  charges exactly those planes' compressed bytes per decode-step read.

A copy of the reference's ``serving/kv_cache.py`` without its
shared-prefix machinery (prefix sharing is a later slice).  A page arrives
as a NumPy array of raw bf16 bit patterns (``uint16``) or as an
:class:`~repro_torch.core.compressed_store.EncodedKV` that the device
already clustered, delta-encoded and bit-plane packed; either way the
controller stores exactly the blobs the reference stores for its NumPy
bf16 extension-type pages.  :meth:`CompressedKVStore.put_sequence` and
:meth:`~CompressedKVStore.get_sequence` transform all of a sequence's
pages at once, on the device the KV lies on (or is asked for).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.bitplane import SPECS, FloatSpec
from repro_torch.core.compressed_store import (
    StoreConfig,
    bits_tensor,
    decompress_kv_pages,
    encode_pages,
)
from repro_torch.core.controller import MemoryController

PAGE_TOKENS = 16


def page_valid(tokens: int) -> list:
    """Valid tokens of each PAGE_TOKENS page of ``tokens`` tokens: the tail
    page is padded when it is transformed (by repeating the last token, so
    the pad never pollutes the delta-decorrelation stats); the valid
    counts keep the store's logical accounting pad-free."""
    return [min(PAGE_TOKENS, tokens - p) for p in range(0, tokens, PAGE_TOKENS)]


@dataclasses.dataclass
class PageKey:
    seq_id: int
    layer: int
    page_idx: int
    stream: str = "k"  # 'k' | 'v'

    def astuple(self) -> Tuple:
        return (self.seq_id, self.layer, self.page_idx, self.stream)


class PageEvictedError(KeyError):
    """Raised when a page was LRU-evicted under the byte budget; the caller
    re-activates it by re-putting from the device working set."""


class CompressedKVStore:
    """Host-side paged store with compression on write and LRU eviction.

    ``max_stored_bytes=None`` (default) disables the budget.  With a
    budget, puts evict cold pages LRU-first until the compressed footprint
    fits (a single page larger than the whole budget is kept: evicting the
    page just written would livelock the writer).
    """

    def __init__(self, spec: FloatSpec = SPECS["bf16"],
                 config: StoreConfig | None = None,
                 max_stored_bytes: int | None = None,
                 controller: MemoryController | None = None,
                 engine=None):
        self.spec = spec
        self.config = config or StoreConfig()
        self.max_stored_bytes = max_stored_bytes
        self.controller = controller or MemoryController(self.config)
        #: optional memctl CompressionEngineRuntime — budget evictions then
        #: queue a background write-back job instead of being free/instant
        self.engine = engine
        self._lru: "OrderedDict[Tuple, int]" = OrderedDict()  # key -> stored bytes
        self._planes: Dict[Tuple, int | None] = {}  # ladder hints
        self._logical = 0
        self._stored = 0
        self.counters = {
            "evictions": 0, "evicted_bytes": 0,
            "hits": 0, "misses": 0, "reactivations": 0,
        }

    # ------------------------------------------------------------------ pages
    def put_page(self, key: PageKey, kv,
                 planes: int | None = None,
                 valid_tokens: int | None = None) -> None:
        """kv: (PAGE_TOKENS, channels) in the store's value dtype (bf16 as
        its uint16 bit patterns), or the page already transformed on the
        device (an ``EncodedKV`` of that shape, planes on the host).

        ``valid_tokens`` < PAGE_TOKENS marks an exact-length tail page: the
        trailing rows are physical padding (repeats of the last real token)
        and are excluded from the logical-byte accounting."""
        if kv.shape[0] != PAGE_TOKENS:
            raise ValueError(f"a page holds {PAGE_TOKENS} tokens, got {kv.shape}")
        kt = key.astuple()
        if kt in self._lru:
            self._forget(kt)
        valid_values = (None if valid_tokens is None or valid_tokens >= PAGE_TOKENS
                        else valid_tokens * int(np.prod(kv.shape[1:])))
        ct = self.controller.write_kv_page(kt, kv, self.spec,
                                           valid_values=valid_values)
        self._lru[kt] = ct.stored_bytes
        self._planes[kt] = planes
        self._logical += ct.valid_logical_bytes
        self._stored += ct.stored_bytes
        self._enforce_budget(protect=kt)

    def get_page(self, key: PageKey, keep_planes: int | None = None,
                 device=None):
        """Decompress a page (optionally at reduced precision): NumPy with
        ``device=None``, else raw bits on ``device``.  Raises
        :class:`PageEvictedError` if the budget already reclaimed it."""
        kt = key.astuple()
        self._require(kt)
        self._lru.move_to_end(kt)
        if keep_planes is None:
            keep_planes = self._planes.get(kt)
        return self.controller.read_kv_page(kt, keep_planes, device)

    def account_fetch(self, key: PageKey, keep_planes: int | None = None) -> int:
        """Accounting-only read (values already resident on device): logs the
        kv_read event at the ladder precision and returns physical bytes."""
        kt = key.astuple()
        self._require(kt)
        self._lru.move_to_end(kt)
        if keep_planes is None:
            keep_planes = self._planes.get(kt)
        return self.controller.account_kv_read(kt, keep_planes)

    def set_planes(self, key: PageKey, planes: int | None) -> None:
        kt = key.astuple()
        if kt in self._lru:
            self._planes[kt] = planes

    def contains(self, key: PageKey) -> bool:
        return key.astuple() in self._lru

    def note_miss(self) -> None:
        """Record a fetch that found its page already evicted (the engine's
        service-time fetch sizing detects the miss via :meth:`contains`)."""
        self.counters["misses"] += 1

    def page_logical_bytes(self, key: PageKey) -> int:
        """Pad-free logical bytes of a resident page — what a DENSE device
        cache reads for it regardless of the ladder."""
        return self.controller.kv_page(key.astuple()).valid_logical_bytes

    def fetch_plan(self, key: PageKey) -> Tuple[int, int]:
        """(engine bytes, plane count) for a fetch resolved *now*, at the
        page's ladder hint.  Called once, at service start, so the lane-pool
        bytes and the controller's kv_read charge use the same assignment.
        Lane throughput is rated on the decompressed side, so a
        partial-plane fetch costs planes/bits of the pad-free logical page."""
        kt = key.astuple()
        ct = self.controller.kv_page(kt)
        keep = self._planes.get(kt)
        if keep is None:
            return ct.valid_logical_bytes, ct.spec.bits
        return (max(1, round(ct.valid_logical_bytes * keep / ct.spec.bits)),
                keep)

    # -------------------------------------------------------------- sequences
    def put_sequence(self, seq_id: int, layer: int, stream: str, kv,
                     first_page: int = 0, planes: int | None = None) -> int:
        """kv: (tokens, channels), NumPy (bf16 as uint16) or a tensor (any
        strides, channels dense, read in place); the tail page is padded in
        the transform.  All pages are transformed in one ``encode_kv`` on
        the tensor's device (a NumPy input on the CPU), then put page by
        page.  Returns pages written.

        ``first_page`` offsets the page index — the scheduler streams decode
        pages into the store incrementally as each fills."""
        bits = bits_tensor(kv, self.spec)
        valid = page_valid(bits.shape[0])
        for p, (page, v) in enumerate(zip(encode_pages(bits, self.spec, self.config,
                                                       PAGE_TOKENS), valid)):
            self.put_page(PageKey(seq_id, layer, first_page + p, stream), page,
                          planes=planes, valid_tokens=v)
        return len(valid)

    def get_sequence(self, seq_id: int, layer: int, stream: str, tokens: int,
                     keep_by_page: dict | None = None, device=None):
        """The first ``tokens`` rows of a sequence, each page at its
        ``keep_by_page`` planes (else its ladder hint, else full).  Pages
        are checked and charged one kv_read each, in page order, as the
        reference's per-page loop does (a miss raises
        :class:`PageEvictedError` after the earlier pages were charged);
        then all pages decode together (one unpack and one exponent-delta
        decode): NumPy with ``device=None``, else raw bits on ``device``."""
        cts, keeps = [], []
        for p in range(-(-tokens // PAGE_TOKENS)):
            kt = PageKey(seq_id, layer, p, stream).astuple()
            self._require(kt)
            self._lru.move_to_end(kt)
            keep = (keep_by_page or {}).get(p)
            keep = self._planes.get(kt) if keep is None else keep
            self.controller.account_kv_read(kt, keep)
            cts.append(self.controller.kv_page(kt))
            keeps.append(keep)
        parts = decompress_kv_pages(cts, keeps, device)
        cat = np.concatenate if device is None else torch.cat
        return cat(parts)[:tokens]

    def drop_sequence(self, seq_id: int) -> None:
        """Retire a finished request: free its pages (no bus traffic)."""
        for kt in [k for k in self._lru if k[0] == seq_id]:
            self._forget(kt)

    # -------------------------------------------------------------- eviction
    def _require(self, kt: Tuple) -> None:
        if kt not in self._lru:
            self.counters["misses"] += 1
            raise PageEvictedError(kt)
        self.counters["hits"] += 1

    def _forget(self, kt: Tuple) -> None:
        stored = self._lru.pop(kt)
        self._planes.pop(kt, None)
        ct = self.controller.drop_kv_page(kt)
        self._stored -= stored
        if ct is not None:
            self._logical -= ct.valid_logical_bytes

    def _enforce_budget(self, protect: Tuple) -> None:
        if self.max_stored_bytes is None:
            return
        while self._stored > self.max_stored_bytes and len(self._lru) > 1:
            victim = next(kt for kt in self._lru if kt != protect)
            stored = self._lru[victim]
            self._forget(victim)
            self.counters["evictions"] += 1
            self.counters["evicted_bytes"] += stored
            if self.engine is not None:
                # the engine streams the victim's compressed bytes out to
                # the capacity tier: background lane occupancy, no bus event.
                # seq_id=None: committed work that survives the owner's
                # retirement (the drain loop services it)
                self.engine.submit_eviction(victim, stored, seq_id=None)

    # ------------------------------------------------------------ accounting
    def footprint(self) -> dict:
        return {
            "pages": len(self._lru),
            "logical_bytes": self._logical,
            "stored_bytes": self._stored,
            "ratio": self._logical / max(1, self._stored),
            "saving": 1.0 - self._stored / max(1, self._logical),
            "budget_bytes": self.max_stored_bytes,
            **self.counters,
        }
