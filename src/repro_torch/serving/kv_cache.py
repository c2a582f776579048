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

Shared-prefix pages, as in the reference:

* **Content-addressed prompt pages.** Under ``EngineConfig.prefix_sharing``
  the backend keys every FULL prompt page by a rolling hash of its
  token-id chain (:func:`page_chain_hashes`) instead of the request id, so
  a shared page-aligned prefix is stored once however many requests hold
  it.  Decode and tail pages stay request-keyed: a diverging chunk changes
  the chain hash and therefore the key (copy-on-write at page
  granularity).
* **Refcount binding.** A request admitted through a prefix match binds
  the matched pages (``retain_page``/``release_page``).  A bound page is
  never a budget-eviction victim and ``drop_page`` refuses it; among
  refcount-0 pages the LRU sweep prefers request-keyed victims, so the
  prefix cache is the last thing pressure reclaims.
* **:class:`PrefixIndex`.** The submit-time matcher: each page's chain
  hash maps to its registered :class:`PrefixEntry` (token ids, to verify a
  match, and the snapshot of the prefix's device KV rows that a joining
  slot adopts instead of re-running prefill).  The port keeps the
  snapshot on the device, as raw bf16 bits.

A copy of the reference's ``serving/kv_cache.py``.  A page arrives
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
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

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

#: seq-id namespace of content-addressed shared-prefix pages, disjoint from
#: integer request ids: ``drop_sequence(rid)`` never touches a shared page
PREFIX_SEQ = "px:"

#: chain seed: hashes are versioned so a page-format change cannot match
#: pages written by an older layout (the reference's seed, so that both
#: packages key a prefix alike)
_CHAIN_SEED = b"repro-prefix-v1"


def prefix_seq_id(digest: str) -> str:
    """Store seq-id for the shared page whose chain hash is ``digest``."""
    return PREFIX_SEQ + digest


def is_prefix_seq(seq_id) -> bool:
    """Whether a page-key seq-id names a shared (content-addressed) page."""
    return isinstance(seq_id, str) and seq_id.startswith(PREFIX_SEQ)


def page_chain_hashes(tokens) -> List[str]:
    """Rolling hash per FULL page of ``tokens``: ``h[i]`` digests pages
    [0, i] of the int32 token-id stream, so equal hashes mean equal
    page-aligned prefixes (verified against the raw ids on match: the hash
    only routes).  A ragged tail (< PAGE_TOKENS tokens) gets no hash."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[str] = []
    prev = _CHAIN_SEED
    for p in range(len(arr) // PAGE_TOKENS):
        chunk = arr[p * PAGE_TOKENS:(p + 1) * PAGE_TOKENS].tobytes()
        prev = hashlib.blake2b(prev + chunk, digest_size=8).digest()
        out.append(prev.hex())
    return out


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
        #: shared-prefix binding counts: a key is bound while a live request
        #: reads it without owning it; survives _forget (binding belongs to
        #: the requests, not to residency)
        self._refcounts: Dict[Tuple, int] = {}
        self._logical = 0
        self._stored = 0
        self._shared_stored = 0
        self._shared_pages = 0
        self.counters = {
            "evictions": 0, "evicted_bytes": 0,
            "hits": 0, "misses": 0, "reactivations": 0,
            "shared_evictions": 0,
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
        if is_prefix_seq(kt[0]):
            self._shared_stored += ct.stored_bytes
            self._shared_pages += 1
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

    def fetch_plan(self, key: PageKey, keep="ladder") -> Tuple[int, int]:
        """(engine bytes, plane count) for a fetch resolved *now*.  Called
        once, at service start, so the lane-pool bytes and the controller's
        kv_read charge use the same assignment.  Lane throughput is rated
        on the decompressed side, so a partial-plane fetch costs
        planes/bits of the pad-free logical page.

        ``keep`` overrides the store's ladder hint (a shared page is fetched
        at each holder's own ladder assignment, not at whichever holder
        wrote the hint last); the default reads the hint."""
        kt = key.astuple()
        ct = self.controller.kv_page(kt)
        if keep == "ladder":
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

    def drop_page(self, key: PageKey) -> bool:
        """Forget one page without eviction accounting (no bus bytes: the
        page is dead, not cold); returns whether it was dropped.  A page
        another holder still binds (refcount > 0) is not dead: the drop is
        refused, and the last holder's release leaves it droppable."""
        kt = key.astuple()
        if self._refcounts.get(kt, 0) > 0 or kt not in self._lru:
            return False
        self._forget(kt)
        return True

    # ------------------------------------------------------------- refcounts
    def retain_page(self, key: PageKey) -> int:
        """Bind a shared page to one more live holder; returns the new
        refcount.  Bound pages are immune to budget eviction and
        :meth:`drop_page` until released back to zero."""
        kt = key.astuple()
        n = self._refcounts.get(kt, 0) + 1
        self._refcounts[kt] = n
        if kt in self._lru:
            self._lru.move_to_end(kt)
        return n

    def release_page(self, key: PageKey) -> int:
        """Drop one holder's binding; returns the remaining refcount.  The
        page stays resident at refcount 0 (it is the prefix cache) but is
        evictable again."""
        kt = key.astuple()
        n = self._refcounts.get(kt, 0)
        if n <= 1:
            self._refcounts.pop(kt, None)
            return 0
        self._refcounts[kt] = n - 1
        return n - 1

    def page_refcount(self, key: PageKey) -> int:
        return self._refcounts.get(key.astuple(), 0)

    def page_stored_bytes(self, key: PageKey) -> int:
        """Compressed bytes a resident page occupies (0 if evicted): what a
        prefix-matched request would otherwise have stored again."""
        return self._lru.get(key.astuple(), 0)

    def sequence_pages(self, seq_id) -> list:
        return [k for k in self._lru if k[0] == seq_id]

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
        if is_prefix_seq(kt[0]):
            self._shared_stored -= stored
            self._shared_pages -= 1
        if ct is not None:
            self._logical -= ct.valid_logical_bytes

    def _pick_victim(self, protect: Tuple) -> Tuple | None:
        """Coldest evictable page: never ``protect`` (the page being
        written), never a bound page, and an unshared (request-keyed) page
        before a refcount-0 shared one at any temperature."""
        fallback = None
        for kt in self._lru:
            if kt == protect or self._refcounts.get(kt, 0) > 0:
                continue
            if not is_prefix_seq(kt[0]):
                return kt
            if fallback is None:
                fallback = kt
        return fallback

    def _enforce_budget(self, protect: Tuple) -> None:
        if self.max_stored_bytes is None:
            return
        while self._stored > self.max_stored_bytes and len(self._lru) > 1:
            victim = self._pick_victim(protect)
            if victim is None:
                # everything else is bound by live requests: over-budget
                # residency is the lesser evil against killing pages in use
                return
            stored = self._lru[victim]
            if is_prefix_seq(victim[0]):
                self.counters["shared_evictions"] += 1
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
            "shared_pages": self._shared_pages,
            "shared_stored_bytes": self._shared_stored,
            "bound_pages": sum(1 for n in self._refcounts.values() if n > 0),
            **self.counters,
        }


# ---------------------------------------------------------------- prefix index
@dataclasses.dataclass
class PrefixEntry:
    """One registered shareable prefix.

    ``tokens`` are the raw prompt ids the hashes digest (a match verifies
    against them, so an 8-byte hash collision can never cross-wire two
    prompts).  ``k``/``v`` are snapshots of the prefix's device KV rows over
    every model layer, ``(n_layers, end_token - r0_token, channels)`` raw
    bf16 bits (``int16``) on the backend's device, starting at absolute
    token ``r0_token``: a matching slot adopts these rows into its device
    cache instead of re-running prefill."""

    tokens: np.ndarray          # (end_token,) int32 prompt prefix
    hashes: List[str]           # chain hashes, one per full page
    r0_token: int               # first token covered by the snapshot
    k: Optional[torch.Tensor]   # (n_layers, end - r0, channels) int16
    v: Optional[torch.Tensor]


class PrefixIndex:
    """Maps page chain-hashes to registered prefixes (LRU over entries).

    ``match`` walks a new prompt's page hashes to the longest registered
    page-aligned prefix; the caller then checks store residency and binds
    refcounts.  Lookup is per page hash, so a long registered prefix
    serves shorter matches at any page boundary."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self._pages: Dict[str, PrefixEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def has_page(self, h: str) -> bool:
        return h in self._pages

    def register(self, entry: PrefixEntry) -> bool:
        """Index a finished prefill's prefix; returns whether it was new.
        A prefix whose final page hash is already indexed is a duplicate
        (same token chain) and is skipped."""
        if not entry.hashes:
            return False
        last = entry.hashes[-1]
        if last in self._entries:
            self._entries.move_to_end(last)
            return False
        self._entries[last] = entry
        for h in entry.hashes:
            # any entry covering a hash serves it identically (same chain)
            self._pages.setdefault(h, entry)
        while len(self._entries) > self.max_entries:
            _, old = self._entries.popitem(last=False)
            for h in old.hashes:
                if self._pages.get(h) is old:
                    del self._pages[h]
        return True

    def match(self, prompt, hashes: List[str],
              max_pages: int | None = None) -> Tuple[int, Optional[PrefixEntry]]:
        """Longest indexed page-aligned prefix of ``prompt``: ``hashes`` is
        ``page_chain_hashes(prompt)`` (possibly truncated), ``max_pages``
        caps the match further.  Returns ``(matched_pages, entry)``, entry
        None when nothing matched.  Token ids are verified against the
        entry, so a hash collision fails closed."""
        n = len(hashes)
        if max_pages is not None:
            n = min(n, max_pages)
        m = 0
        while m < n and hashes[m] in self._pages:
            m += 1
        while m > 0:
            entry = self._pages[hashes[m - 1]]
            t = m * PAGE_TOKENS
            if (len(entry.tokens) >= t
                    and np.array_equal(np.asarray(prompt[:t], np.int32),
                                       np.asarray(entry.tokens[:t], np.int32))):
                self._entries.move_to_end(entry.hashes[-1])
                return m, entry
            m -= 1  # collision: back off a page and verify again
        return 0, None
