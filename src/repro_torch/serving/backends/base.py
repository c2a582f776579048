"""``KVBackend``: the protocol between the continuous-batching scheduler
and the memory tier (port of the reference's ``serving/backends/base.py``).

The base class is the single-tier, full-attention paged tier; subclasses
override the routing and layout hooks (``_build_tiers``, ``_seq_key``,
``_page_targets``, ``_device_rows``, ``_first_storable_token``,
``_expire_dead_pages``, ``_can_reactivate``, ``_device_page``,
``check_model`` ...), never the scheduler-facing surface:

* ``PagedBackend``  — one device, one compressed paged tier;
* ``ShardedBackend`` — per-shard compressed tiers and lane engines, pages
  routed by KV-head ownership or block-cyclically over the sequence;
* ``RingBackend``   — per-slot sliding-window ring caches (Mixtral-family
  configs), pages retired as they slide out of the window.

Protocol surface (what the scheduler calls — everything else is private):

========================  ===================================================
``ensure_cache()``        build/return the device decode cache
``cache`` (property)      get/set the device cache between model calls
``sync_lens``             publish the per-slot true lengths (and a staged
                          cache's staging bases) to the cache
``adopt_prefill``         padded admission: copy a one-sequence prefill
                          cache into a slot
``max_prefill_bucket()``  largest chunk the backend's cache layout accepts
``bind_slot/retire``      slot lifecycle (retire cancels queued engine jobs
                          and drops the request's pages)
``on_prefill_progress``   store newly completed prompt KV (pages + ragged
                          exact-length tail), assign ladder planes when done
``on_decode_token``       store a filled decode page, re-rank the ladder,
                          queue this step's decode-critical fetches
``tick/backlog``          service the engine window / queued work
``admit_pressure_ns()``   engine-limited latency signal for admission
``note_peaks/report``     footprint peaks + savings/engine stats
========================  ===================================================

The device cache lives on the backend's torch device; the store,
controller and lane engine are host-side copies of the reference's.  A
stored page is transformed on the device (cluster, exponent delta,
bit-plane pack: ``compressed_store.encode_kv``, one call per span); only
its planes and bases cross to the host, where the codec runs.

Shared-prefix pages (``EngineConfig.prefix_sharing``): full prompt pages
are keyed by their token chain's hash, a finished prefill registers a
snapshot of its prompt rows (every layer, one unpack of the device cache,
kept on the device as raw bf16 bits), and a later prompt with the same
page-aligned prefix binds those pages by refcount and adopts the rows into
its slot (one pack of the snapshot for a bit-plane cache, a device copy for
a dense one) instead of prefilling them.  Compressed weight streaming
(``weight_stream='compressed'``): :meth:`KVBackend.attach_weights` stores
the layer weights block-compressed behind the controller and every step
that computes streams one weight pass through the lane engine; compute
keeps the resident weights, as in the reference.

Staged decode caches (``decode_staging > 0``) serve on this backend with
``device_kv="dense"``: the cache carries a staging ring and per-row
staging bases (``'sbase'``), anchored at each slot's prefill end and
advanced in lockstep with the device's folds; the tokens still in a ring
are read from it where the tier copies or ranks a slot's rows.  Legacy
padded admission (``prefill_mode="padded"``) copies a one-sequence prefill
cache into a slot (:meth:`KVBackend.adopt_prefill`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compression import default_codec
from repro_torch.core.compressed_store import StoreConfig, encode_pages
from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import (
    assign_page_precision,
    page_minmax,
    quest_scores,
)
from repro_torch.kernels.bitplane.ops import pack_kv_into, unpack_kv_pair
from repro_torch.kernels.paged_attention.ops import unpack_kv
from repro_torch.memctl import CompressionEngineRuntime, Job, JobClass
from repro_torch.memctl.runtime import aggregate_engine_reports
from repro_torch.models.transformer import bitplane_cache_from_dense, split_layer_params
from repro_torch.serving.kv_cache import (
    PAGE_TOKENS,
    CompressedKVStore,
    PageEvictedError,
    PageKey,
    PrefixEntry,
    PrefixIndex,
    page_chain_hashes,
    page_valid,
    prefix_seq_id,
)
from repro_torch.telemetry.collector import NULL_COLLECTOR
from repro_torch.weights import CompressedWeightStore, WeightStreamer

#: stat keys the backend mutates on the (shared) scheduler stats dict
BACKEND_STATS = (
    "kv_fetch_misses", "kv_fetch_deferrals", "kv_reactivations",
    "engine_jobs_cancelled", "kv_peak_stored_bytes", "kv_peak_logical_bytes",
    "device_bytes_read",
    "prefix_requests_matched", "prefix_tokens_matched",
    "prefix_pages_matched", "prefix_bytes_deduped",
)


@dataclasses.dataclass
class SlotState:
    """Backend-side per-slot bookkeeping."""

    rid: int
    #: device tokens [0, stored_tokens) have been submitted to the store
    #: (exact-length tail pages included); fetch accounting and
    #: re-activation range over exactly these pages
    stored_tokens: int = 0
    #: ladder plane count per page index (consulted by queued write jobs at
    #: service time, so evicted pages keep their precision)
    page_planes: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: first page not yet fully slid out of the attention window (ring
    #: tiers; always 0 for full-attention backends)
    live_from_page: int = 0
    #: last plane-map row pushed to the device cache (bit-plane layout) —
    #: lets per-token re-syncs skip the device write when nothing changed
    device_row: Optional[np.ndarray] = None
    # --- shared-prefix state (EngineConfig.prefix_sharing; empty = cold) ---
    #: chain hash per FULL prompt page: page p < prompt_pages is keyed
    #: ``px:<hash[p]>`` instead of the rid, so equal prefixes share store
    #: pages; tail and decode pages stay rid-keyed
    prefix_hashes: List[str] = dataclasses.field(default_factory=list)
    #: raw prompt ids the hashes digest (a registration keeps them so that
    #: a match verifies token equality, not just hash equality)
    prefix_tokens: Optional[np.ndarray] = None
    #: number of FULL prompt pages (== len(prefix_hashes))
    prompt_pages: int = 0
    #: pages [bound_from_page, shared_pages) were adopted through a prefix
    #: match and hold a store refcount each, released at retire, or as a
    #: ring window slides past them (advancing bound_from_page)
    shared_pages: int = 0
    bound_from_page: int = 0
    #: staged decode (``decode_staging > 0``): the first token living in the
    #: slot's staging ring — the main cache holds [0, stage_base), the ring
    #: [stage_base, len); mirrors the device 'sbase' row
    stage_base: int = 0


class MemTier:
    """One memory stack: MemoryController + CompressedKVStore +
    finite-throughput CompressionEngineRuntime, wired as the reference
    wires it (codec resolution included)."""

    def __init__(self, cfg, controller: MemoryController | None = None,
                 max_stored_bytes: int | None = None, index: int = 0,
                 telemetry=None):
        self.index = index
        codec = cfg.codec or default_codec()
        store_cfg = StoreConfig(codec=codec)
        # accounting-only by default: one event per resident page per decode
        # step would grow without bound on long runs
        if controller is None:
            controller = MemoryController(store_cfg, retain_events=False)
        elif cfg.codec is None:
            # no explicit codec: follow the caller's controller
            codec = controller.config.codec
            store_cfg = controller.config
        else:
            # explicit codec wins end to end
            controller.config = store_cfg
        mc = cfg.engine
        if mc.engine is None:  # lane silicon follows the serving codec
            mc = dataclasses.replace(
                mc, engine=codec if codec in ("lz4", "zstd") else "lz4"
            )
        self.engine = CompressionEngineRuntime(mc, telemetry=telemetry,
                                               tier=index)
        controller.attach_engine_clock(self.engine.clock)
        self.controller = controller
        self.store = CompressedKVStore(
            config=store_cfg, max_stored_bytes=max_stored_bytes,
            controller=controller, engine=self.engine,
        )


def make_fetch_job(store: CompressedKVStore, stats: Dict[str, float],
                   key: PageKey, seq_key, device_kv: str = "dense",
                   telemetry=None, rid=None, keep_fn=None) -> Job:
    """Decode-critical fetch with SERVICE-TIME sizing.

    The plane count is resolved exactly once — by ``size_fn`` when the
    engine starts servicing the job — and the completion ``fn`` charges the
    controller's kv_read at that same count, so lane-pool bytes and the
    accounting never disagree across a ladder re-assignment (or an
    eviction) that lands between submit and service.

    The job also accumulates ``device_bytes_read``: a bit-plane device cache
    reads exactly the planes the ladder prescribes; a dense cache reads the
    full-precision page no matter what the ladder charged.

    ``rid`` names the request a live telemetry collector attributes the
    fetch to (default ``key.seq_id``, which a shared page's content key
    does not carry).  ``keep_fn`` resolves the plane count from the
    FETCHING slot's ladder assignment at service time (a shared page is
    ranked by every holder against its own query); None reads the store's
    ladder hint.
    """
    plan: dict = {}
    telemetry = telemetry if telemetry is not None else NULL_COLLECTOR
    rid = key.seq_id if rid is None else rid

    def size() -> int:
        if not store.contains(key):
            store.note_miss()
            return 0  # evicted since submit; fn counts the scheduler miss
        nbytes, keep = store.fetch_plan(key, "ladder" if keep_fn is None else keep_fn())
        plan["keep"] = keep
        plan["device"] = (nbytes if device_kv == "bitplane"
                          else store.page_logical_bytes(key))
        return nbytes

    def fn() -> None:
        if "keep" not in plan:
            stats["kv_fetch_misses"] += 1
            return
        live = telemetry.enabled
        before = (store.controller.stats.kind_device_bytes("kv_read")
                  if live else 0)
        try:
            store.account_fetch(key, keep_planes=plan["keep"])
        except PageEvictedError:
            stats["kv_fetch_misses"] += 1
            return
        stats["device_bytes_read"] = (
            stats.get("device_bytes_read", 0) + plan["device"]
        )
        if live:
            delta = (store.controller.stats.kind_device_bytes("kv_read")
                     - before)
            telemetry.on_fetch(rid, plan["device"], delta)

    return Job(JobClass.DECODE_FETCH, 0, fn=fn, key=key.astuple(),
               seq_id=seq_key, size_fn=size)


def page_part(page, cols: Optional[slice]):
    """One tier's part of a page object: the whole page (``cols`` None) or
    its channels ``cols`` (an :class:`EncodedKV`'s channel encoding, a raw
    page's columns)."""
    if cols is None:
        return page
    if hasattr(page, "columns"):
        return page.columns(cols.start, cols.stop)
    return page[:, cols]


class KVBackend(abc.ABC):
    """Base implementation of the protocol: single-tier, full-attention,
    paged.  Subclasses override the routing and layout hooks, never the
    scheduler-facing surface."""

    name = "?"

    def __init__(self, model, cfg, device: torch.device,
                 controller: MemoryController | None = None,
                 stats: Dict[str, float] | None = None, telemetry=None):
        self.model = model
        self.mcfg = model.cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.device_kv = cfg.device_kv
        self.check_model(model.cfg, cfg)
        self.stats = stats if stats is not None else {}
        for key in BACKEND_STATS:
            self.stats.setdefault(key, 0)
        self.telemetry = telemetry if telemetry is not None else NULL_COLLECTOR
        self.tiers: List[MemTier] = self._build_tiers(controller)
        self._cache = None
        self._slots: Dict[int, SlotState] = {}
        #: device page transforms (one ``encode_kv`` each): page-writing
        #: spans and re-activated pages
        self.page_encodes = {"write_spans": 0, "reactivations": 0}
        # weight streaming: one streamer per tier, built by attach_weights;
        # empty under weight_stream='resident'
        if cfg.weight_stream not in ("resident", "compressed"):
            raise ValueError(
                f"weight_stream must be 'resident' or 'compressed', got "
                f"{cfg.weight_stream!r}")
        self.streamers: list = []
        self._weight_pass_pending = False
        # shared-prefix index: None = sharing off, every page rid-keyed
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(cfg.prefix_index_entries) if cfg.prefix_sharing else None)

    # ------------------------------------------------------------ validation
    @classmethod
    def check_model(cls, mcfg, cfg) -> None:
        """Raise when this backend cannot serve the model/config."""
        if mcfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"continuous batching supports dense-cache families, got "
                f"{mcfg.family!r} (use family-specific engines for "
                f"ssm/hybrid/encdec: every family serves through "
                f"repro_torch.launch's prefill and serve steps)"
            )
        if 0 < mcfg.attn_window < cfg.max_ctx:
            raise NotImplementedError(
                "sliding-window ring caches need backend='ring'"
            )
        if mcfg.decode_staging > 0 and cfg.device_kv != "dense":
            raise ValueError(
                f"decode_staging={mcfg.decode_staging} with "
                f"device_kv={cfg.device_kv!r} is not supported: the staging "
                f"ring appends dense bf16 rows, so staged decode needs "
                f"device_kv='dense'"
            )
        cls.check_device_kv(mcfg, cfg)

    @classmethod
    def check_device_kv(cls, mcfg, cfg) -> None:
        if cfg.device_kv not in ("dense", "bitplane"):
            raise ValueError(
                f"device_kv must be 'dense' or 'bitplane', got "
                f"{cfg.device_kv!r}"
            )
        if cfg.device_kv == "bitplane" and mcfg.head_dim % 8 != 0:
            raise ValueError(
                f"bit-plane packing needs head_dim % 8 == 0, got "
                f"{mcfg.head_dim}"
            )

    # ----------------------------------------------------------------- tiers
    def _build_tiers(self, controller) -> List[MemTier]:
        return [MemTier(self.cfg, controller, self.cfg.max_stored_bytes,
                        telemetry=self.telemetry)]

    def _seq_key(self, tier: MemTier, rid: int):
        """Cancellation scope for jobs of request ``rid`` on ``tier``
        (sharded backends scope it per shard)."""
        return rid

    def _page_targets(self, key: PageKey) -> List[Tuple[MemTier, Optional[slice]]]:
        """Which tiers own (a channel slice of) this page: [(tier, cols)];
        ``cols`` None is the whole page."""
        return [(self.tiers[0], None)]

    # -------------------------------------------------------- weight streaming
    def attach_weights(self, params) -> None:
        """Ingest the model's per-layer weight handles into each tier's
        block-compressed weight store and build the streamers
        (``weight_stream='compressed'``; a no-op under 'resident').  Each
        tensor's raw bits are copied to the host once and compressed there
        by the controller's codec."""
        if self.cfg.weight_stream != "compressed":
            return
        handles = split_layer_params(params)
        n = len(self.tiers)
        self.streamers = []
        for tier in self.tiers:
            store = CompressedWeightStore.from_handles(
                handles, tier.controller, part=(tier.index, n))
            self.streamers.append(WeightStreamer(
                store, tier.engine, telemetry=self.telemetry,
                prefetch_depth=self.cfg.weight_prefetch_depth,
                tier=tier.index))

    def _note_compute(self) -> None:
        """A prefill chunk or decode token ran this step: the step's engine
        window carries one weight pass (all compute in a step shares the
        streamed layer buffers — weight bytes are charged exactly once per
        layer per step)."""
        self._weight_pass_pending = True

    # ---------------------------------------------------------- device cache
    @property
    def cache(self):
        """The device decode cache (passed whole into the model calls)."""
        return self._cache

    @cache.setter
    def cache(self, value):
        self._cache = value

    def ensure_cache(self):
        if self._cache is None:
            cache = self.model.init_cache(self.cfg.max_batch, self.cfg.max_ctx,
                                          self.device)
            if self.device_kv == "bitplane":
                cache = bitplane_cache_from_dense(cache, page_tokens=PAGE_TOKENS)
            cache["len"] = torch.zeros(self.cfg.max_batch, dtype=torch.int32,
                                       device=self.device)
            if "sk" in cache:  # staged decode: per-row staging bases
                cache["sbase"] = torch.zeros(self.cfg.max_batch, dtype=torch.int32,
                                             device=self.device)
            self._cache = cache
        return self._cache

    def device_keeps(self) -> Optional[tuple]:
        """Plane-count set the device decode kernel may be asked to read
        (the rung strategy launches once per member) — the ladder's rung
        planes plus full precision.  ``None`` on the dense layout."""
        if self.device_kv != "bitplane":
            return None
        bits = self.tiers[0].store.spec.bits
        keeps = {bits}
        if self.cfg.ladder is not None:
            keeps |= {planes for _, planes in self.cfg.ladder.rungs}
        return tuple(sorted(keeps))

    def sync_lens(self, lens, stage_anchor) -> None:
        """Publish the slots' lengths for the next decode step and, on a
        staged cache, each row's staging base: windows of ws tokens
        anchored at the row's prefill end (``stage_anchor``; -1 = no anchor,
        an idle or mid-prefill row, whose base is its length)."""
        lens = np.asarray(lens, np.int32)
        self._cache["len"] = torch.as_tensor(lens, device=self.device)
        if "sbase" in self._cache:
            ws = self._cache["sk"].shape[2]
            anchor = np.where(np.asarray(stage_anchor) >= 0, stage_anchor, lens)
            base = anchor + ws * ((lens - anchor) // ws)
            self._cache["sbase"] = torch.as_tensor(base.astype(np.int32),
                                                   device=self.device)

    def adopt_prefill(self, slot_id: int, pcache, s: int) -> None:
        """Legacy padded admission: copy a one-sequence prefill cache
        {'k', 'v': (L, 1, s', Hkv, hd)} into this slot's rows [0, s), IN
        PLACE (the reference's ``.at[:, slot, :s].set``); the bit-plane
        layout packs every layer's K and V on adoption, in one launch."""
        cache = self.ensure_cache()
        if self.device_kv == "bitplane":
            # (L, bits, B, S, Hkv, hd8) -> the slot's (bits, L, S, Hkv, hd8) views
            kp, vp = (cache[name][:, :, slot_id].movedim(1, 0)
                      for name in ("k_planes", "v_planes"))
            pack_kv_into(pcache["k"][:, 0, :s], pcache["v"][:, 0, :s], kp, vp, 0)
            return
        for name in ("k", "v"):
            cache[name][:, slot_id, :s] = pcache[name][:, 0, :s].to(cache[name].dtype)

    def _staged_rows(self, slot_id: int, t0: int, t1: int):
        """Tokens of [t0, t1) that still live in a staged slot's ring: (first
        token, ring slot, count), or None (no ring, or none of them)."""
        st = self._slots.get(slot_id)
        if "sk" not in self._cache or st is None:
            return None
        sb = st.stage_base
        lo, hi = max(t0, sb), min(t1, sb + self._cache["sk"].shape[2])
        return (lo, lo - sb, hi - lo) if hi > lo else None

    def max_prefill_bucket(self) -> int:
        """Largest prefill chunk the cache layout accepts (ring caches cap
        it at the window so a chunk's slots never collide)."""
        return self.cfg.max_ctx

    def _device_rows(self, t0: int, t1: int):
        """Cache sequence-axis rows holding absolute tokens [t0, t1): a
        slice, or an index array where they wrap around a ring."""
        return slice(t0, t1)

    def _take_rows(self, t: torch.Tensor, dim: int, t0: int, t1: int) -> torch.Tensor:
        """Tokens [t0, t1) of a cache tensor along its sequence ``dim``: a
        view for a slice of rows, a copy for wrapped ring rows."""
        rows = self._device_rows(t0, t1)
        if isinstance(rows, slice):
            return t.narrow(dim, rows.start, rows.stop - rows.start)
        return t.index_select(dim, torch.as_tensor(rows, device=t.device))

    def _row_runs(self, t0: int, t1: int) -> list:
        """Tokens [t0, t1) as runs of consecutive cache rows: (first row,
        offset into the tokens, length) each."""
        rows = self._device_rows(t0, t1)
        if isinstance(rows, slice):
            return [(rows.start, 0, t1 - t0)]
        cuts = [0] + [i for i in range(1, len(rows)) if rows[i] != rows[i - 1] + 1] + [len(rows)]
        return [(int(rows[a]), a, b - a) for a, b in zip(cuts, cuts[1:])]

    def stored_layers(self) -> int:
        n_layers = self.mcfg.n_layers
        cap = self.cfg.store_layers
        return n_layers if cap is None else min(cap, n_layers)

    def slot_kv_bits(self, slot_id: int, t0: int, t1: int,
                     layers: Optional[slice] = None) -> torch.Tensor:
        """This slot's KV rows [t0, t1) of the stored layers (or of the
        model's ``layers`` slice) on the device, as raw bf16 bits: (layers,
        2 streams k/v, tokens, channels) ``int16``.  The bit-plane layout
        unpacks both streams at full precision in one launch, reading the
        cache's planes in place — packing is a bf16 bitcast, so the bits
        equal the dense layout's."""
        if layers is None:
            layers = slice(0, self.stored_layers())
        t = t1 - t0
        if self.device_kv == "bitplane":
            # (L, bits, B, T, Hkv, hd8) -> (bits, layers, t, Hkv, hd8) views
            # of each stream, unpacked together -> (2, layers, t, Hkv, hd)
            kp, vp = (self._take_rows(self._cache[name][layers, :, slot_id], 2, t0, t1)
                      .movedim(1, 0) for name in ("k_planes", "v_planes"))
            dense = unpack_kv_pair(kp, vp, kp.shape[0], kp.shape[0])
        else:
            dense = torch.stack([self._take_rows(self._cache[name][layers, slot_id], 1, t0, t1)
                                 for name in ("k", "v")])
            staged = self._staged_rows(slot_id, t0, t1)
            if staged is not None:
                # staged decode: tokens >= stage_base still live in the
                # staging ring, not the main cache — read them from there
                lo, r0, n = staged
                dense = dense.clone()
                dense[:, :, lo - t0:lo - t0 + n] = torch.stack(
                    [self._cache[name][layers, slot_id, r0:r0 + n] for name in ("sk", "sv")])
        return dense.reshape(2, -1, t, dense.shape[-2] * dense.shape[-1]) \
            .transpose(0, 1).view(torch.int16)

    def encode_span(self, bits: torch.Tensor) -> tuple:
        """Raw KV bits (..., tokens, channels), e.g. :meth:`slot_kv_bits`'
        view -> (one page object per (..., page) in row-major order, valid
        tokens per page): every page transformed in one ``encode_kv`` call
        on the device that reads the view in place and pads the tail page
        by repeating the last token, the planes and bases copied to the
        host once (``compressed_store.encode_pages``)."""
        store = self.tiers[0].store
        return (encode_pages(bits, store.spec, store.config, PAGE_TOKENS),
                page_valid(bits.shape[-2]))

    # --------------------------------------------------------- slot lifecycle
    def bind_slot(self, slot_id: int, rid: int) -> None:
        self._slots[slot_id] = SlotState(rid=rid)
        self._reset_device_planes(slot_id)

    def _reset_device_planes(self, slot_id: int) -> None:
        """Bit-plane layout: a reused slot must not inherit the previous
        occupant's ladder — reset its device plane map to full precision."""
        if self.device_kv == "bitplane" and self._cache is not None:
            # in place: the reference's planes.at[slot_id].set(bits)
            self._cache["planes"][slot_id] = self.tiers[0].store.spec.bits

    def retire(self, slot_id: int, rid: int) -> int:
        """Release the slot's shared-page bindings, cancel the request's
        queued engine jobs and drop its pages.  Eviction write-backs carry
        ``seq_id=None`` and survive.  Returns the number of cancelled jobs
        (also accumulated on the stats dict)."""
        st = self._slots.get(slot_id)
        if st is not None:
            self._release_prefix(st)
        cancelled = 0
        for tier in self.tiers:
            cancelled += tier.engine.cancel_seq(self._seq_key(tier, rid))
            # shared (px:) pages are untouched: drop_sequence matches the
            # integer rid only, and the prefix cache outlives its writers
            tier.store.drop_sequence(rid)
        self.stats["engine_jobs_cancelled"] += cancelled
        self._slots.pop(slot_id, None)
        self._reset_device_planes(slot_id)
        return cancelled

    # --------------------------------------------------------- prefix sharing
    def _slot_key(self, st: SlotState, layer: int, page_idx: int,
                  stream: str) -> PageKey:
        """Store key for one of this slot's pages: content-addressed while
        the page is a hashed FULL prompt page (sharing on), rid-keyed
        otherwise (sharing off, ragged prompt tails, decode appends)."""
        if st.prefix_hashes and page_idx < st.prompt_pages:
            return PageKey(prefix_seq_id(st.prefix_hashes[page_idx]),
                           layer, page_idx, stream)
        return PageKey(st.rid, layer, page_idx, stream)

    def _prefix_adopt_lo(self, m: int) -> int:
        """First token a slot adopting an ``m``-token prefix must rebuild:
        0 on the paged tier, whose slot holds every row (a ring window
        reaches back only ``window`` tokens)."""
        return 0

    def _prefix_register_ok(self, st: SlotState, end: int) -> bool:
        """Whether a finished prefill can be indexed for sharing: always on
        the paged tier, whose slot still holds the whole prompt (a ring
        only while the whole prompt is inside its window)."""
        return True

    def match_prefix(self, slot_id: int, prompt) -> int:
        """Longest indexed page-aligned shared prefix this slot can adopt:
        binds the matched pages by refcount, writes the donor snapshot's
        rows into the slot, and returns the matched token count (0 =
        cold).  Called once per slot, at its first prefill tick; it is also
        where the slot's page hashes are computed, so a cold slot writes
        its full prompt pages content-addressed (becoming a donor).

        The match stops one page short of the prompt's end: at least one
        token prefills, and the final chunk's logits give sampling draw 0,
        so a matched request keeps the stream a cold prefill would use."""
        if self.prefix is None or not self.cfg.store_kv_compressed:
            return 0
        st = self._slots[slot_id]
        arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
        hashes = page_chain_hashes(arr)
        st.prefix_hashes = hashes
        st.prefix_tokens = arr
        st.prompt_pages = len(hashes)
        if not hashes:
            return 0
        cap = (len(arr) - 1) // PAGE_TOKENS
        m_pages, entry = self.prefix.match(arr, hashes, max_pages=cap)
        while m_pages > 0:
            m = m_pages * PAGE_TOKENS
            lo = self._prefix_adopt_lo(m)
            if lo < entry.r0_token:
                return 0  # the donor snapshot does not reach back to lo
            bind_from = -(-lo // PAGE_TOKENS)
            missing = self._first_missing_prefix_page(hashes, bind_from, m_pages)
            if missing is None:
                break
            if missing <= bind_from:
                return 0  # nothing resident to bind
            m_pages = missing  # truncate to the resident prefix and retry
        else:
            return 0
        self._adopt_prefix_rows(slot_id, entry, lo, m)
        st.stored_tokens = m
        st.live_from_page = bind_from
        st.bound_from_page = bind_from
        st.shared_pages = m_pages
        deduped = 0
        for p in range(bind_from, m_pages):
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    key = self._slot_key(st, li, p, stream)
                    for tier, _cols in self._page_targets(key):
                        tier.store.retain_page(key)
                        deduped += tier.store.page_stored_bytes(key)
        self.stats["prefix_requests_matched"] += 1
        self.stats["prefix_tokens_matched"] += m
        self.stats["prefix_pages_matched"] += m_pages - bind_from
        self.stats["prefix_bytes_deduped"] += deduped
        if self.telemetry.enabled:
            self.telemetry.on_prefill_chunk(st.rid, 0, m, False)
        return m

    def _first_missing_prefix_page(self, hashes: List[str], p0: int,
                                   p1: int) -> Optional[int]:
        """First page in [p0, p1) not resident on every owning tier (a
        queued but unserviced donor write counts as missing: there is no
        compressed copy to bind yet), or None when all are resident."""
        for p in range(p0, p1):
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    key = PageKey(prefix_seq_id(hashes[p]), li, p, stream)
                    if not all(tier.store.contains(key)
                               for tier, _cols in self._page_targets(key)):
                        return p
        return None

    def _adopt_prefix_rows(self, slot_id: int, entry: PrefixEntry,
                           lo: int, m: int) -> None:
        """Write the donor snapshot's rows [lo, m) of every layer into this
        slot, on the device: one pack of the snapshot into the bit-plane
        cache (all layers in one launch), or a copy into the dense cache.
        Charged to neither the lane engine nor the controller: no prefill
        or compression runs for adopted rows.  Packing is a bf16 bitcast,
        so the adopted planes equal the donor's."""
        cache = self.ensure_cache()
        t, o = m - lo, lo - entry.r0_token
        hkv, hd = self.mcfg.n_kv_heads, self.mcfg.head_dim
        k, v = (x[:, o:o + t].view(torch.bfloat16).reshape(x.shape[0], t, hkv, hd)
                for x in (entry.k, entry.v))
        # (L, bits, B, S, Hkv, hd8) -> the slot's (bits, L, S, Hkv, hd8)
        kp, vp = ((cache[name][:, :, slot_id].movedim(1, 0)
                   for name in ("k_planes", "v_planes"))
                  if self.device_kv == "bitplane" else (None, None))
        for row, off, n in self._row_runs(lo, m):
            kr, vr = k[:, off:off + n], v[:, off:off + n]
            if kp is not None:
                pack_kv_into(kr, vr, kp, vp, row)
            else:
                cache["k"][:, slot_id, row:row + n] = kr
                cache["v"][:, slot_id, row:row + n] = vr

    def _register_prefix(self, slot_id: int, end: int) -> None:
        """Index a finished prefill's full prompt pages for future sharing,
        with a snapshot of their rows over every model layer (adoption
        rebuilds the whole device column, not just the stored layers):
        one ``slot_kv_bits`` on the device, kept there.  Skipped when every
        page hash is already indexed."""
        if self.prefix is None:
            return
        st = self._slots[slot_id]
        n_pages = st.prompt_pages
        if (n_pages == 0 or st.prefix_tokens is None
                or not self._prefix_register_ok(st, end)):
            return
        if all(self.prefix.has_page(h) for h in st.prefix_hashes):
            return
        t1 = n_pages * PAGE_TOKENS
        bits = self.slot_kv_bits(slot_id, 0, t1, layers=slice(None))
        self.prefix.register(PrefixEntry(
            tokens=st.prefix_tokens[:t1].copy(), hashes=list(st.prefix_hashes),
            r0_token=0, k=bits[:, 0], v=bits[:, 1],
        ))

    def _release_prefix(self, st: SlotState) -> None:
        """Drop this slot's remaining shared-page bindings (retire, or a
        ring window sliding past them)."""
        for p in range(st.bound_from_page, st.shared_pages):
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    key = self._slot_key(st, li, p, stream)
                    for tier, _cols in self._page_targets(key):
                        tier.store.release_page(key)
        st.bound_from_page = st.shared_pages

    # ---------------------------------------------------------- page traffic
    def on_prefill_progress(self, slot_id: int, end: int, final: bool) -> None:
        """Prompt KV for tokens [0, end) is now on device: stream the newly
        completed pages to the tier (full pages as chunks land; on the
        final call also the ragged tail as an exact-length page), then
        assign ladder planes and register the prompt's prefix once the
        prompt is complete."""
        self._note_compute()
        if final and self.mcfg.decode_staging > 0:
            # the prompt's KV landed in the main cache: staging anchors here
            self._slots[slot_id].stage_base = end
        if not self.cfg.store_kv_compressed:
            return
        st = self._slots[slot_id]
        self._expire_dead_pages(st, end)
        lo = max(st.stored_tokens, self._first_storable_token(end))
        if lo > st.stored_tokens:
            # a ring skipped a dead prompt prefix entirely: those pages were
            # never stored, so fetch accounting must not range over them
            st.live_from_page = max(st.live_from_page, lo // PAGE_TOKENS)
        hi = end if final else (end // PAGE_TOKENS) * PAGE_TOKENS
        if hi > lo:
            self._write_span(slot_id, lo, hi)
        if hi > st.stored_tokens:
            st.stored_tokens = hi
        if final:
            self._assign_ladder_planes(slot_id, end)
            self._register_prefix(slot_id, end)

    def on_decode_token(self, slot_id: int, ln: int) -> None:
        """One decode token landed at position ln-1: store the page if it
        just filled (and re-rank the ladder), then queue this step's
        decode-critical fetch traffic for the slot."""
        self._note_compute()
        st = self._slots[slot_id]
        ws = self.mcfg.decode_staging
        if ws > 0 and ln - st.stage_base >= ws:
            # the device step just folded a full staging window back into
            # the main cache: advance the host mirror in lockstep
            st.stage_base += ws
        if not self.cfg.store_kv_compressed:
            return
        self._expire_dead_pages(st, ln)
        if ln % PAGE_TOKENS == 0:  # a decode page just filled
            self._write_span(slot_id, ln - PAGE_TOKENS, ln)
            st.stored_tokens = ln
            self._assign_ladder_planes(slot_id, ln)
        self._account_step_fetch(slot_id, ln)

    def _first_storable_token(self, end: int) -> int:
        """First token whose page may still be written (ring backends skip
        pages already outside the window; full attention stores from 0)."""
        return 0

    def _expire_dead_pages(self, st: SlotState, ln: int) -> None:
        """Drop pages that can never be read again (ring only; a no-op
        here)."""

    def _can_reactivate(self, st: SlotState, page_idx: int, ln: int) -> bool:
        """Whether the device working set still holds every row of this
        page (ring backends lose rows as the window slides)."""
        return True

    def _live_page_range(self, st: SlotState) -> Tuple[int, int]:
        """[first, last) stored pages fetch accounting ranges over, from the
        stored-tokens watermark (a growing decode tail never stored is not
        fetched)."""
        return st.live_from_page, -(-st.stored_tokens // PAGE_TOKENS)

    def _write_span(self, slot_id: int, t0: int, t1: int) -> None:
        """Page-split device KV rows [t0, t1) (t0 page-aligned; a ragged t1
        becomes an exact-length tail page), transform every (layer, stream,
        page) of the span on the device at once, and queue one write job
        per page per stream per stored layer."""
        st = self._slots[slot_id]
        pages, valid = self.encode_span(self.slot_kv_bits(slot_id, t0, t1))
        self.page_encodes["write_spans"] += 1
        first_page = t0 // PAGE_TOKENS
        it = iter(pages)
        for li in range(self.stored_layers()):
            for stream in ("k", "v"):
                for j, v in enumerate(valid):
                    self._submit_page_write(
                        st, self._slot_key(st, li, first_page + j, stream), next(it), v
                    )

    def _submit_page_write(self, st: SlotState, key: PageKey, page,
                           valid: int,
                           klass: JobClass = JobClass.KV_WRITE,
                           targets=None) -> None:
        """Queue one page's compress-and-store on each owning tier (its
        part of the page: :func:`page_part`).  The page is transformed at
        submit time (the token range is append-only); the codec, the store
        put — and its charged kv_write — happen when the engine services
        the job, at the ladder planes assigned by then.  ``valid`` <
        PAGE_TOKENS marks an exact-length tail page; the job is sized by its
        pad-free logical bytes.  ``klass=BACKGROUND`` is a re-activation of
        an evicted page on ``targets`` (default: every owning tier)."""
        if targets is None:
            targets = self._page_targets(key)
        for tier, cols in targets:
            part = page_part(page, cols)

            def fn(store=tier.store, part=part):
                store.put_page(key, part, planes=st.page_planes.get(key.page_idx),
                               valid_tokens=valid)
                if klass == JobClass.BACKGROUND:
                    self.stats["kv_reactivations"] += 1

            nbytes = valid * part.shape[1] * tier.store.spec.bits // 8
            tier.engine.submit(Job(klass, nbytes, fn=fn, key=key.astuple(),
                                   seq_id=self._seq_key(tier, st.rid)))

    def _account_step_fetch(self, slot_id: int, ln: int) -> None:
        """Queue this decode step's KV traffic for one slot as
        decode-critical fetch jobs: every stored-resident page at its ladder
        planes, sized at SERVICE time.  Evicted pages queue a background
        re-activation instead; pages whose write or re-activation is still
        queued are skipped (their ground truth is still the device working
        set)."""
        st = self._slots[slot_id]
        rid = st.rid
        p0, n_pages = self._live_page_range(st)
        for li in range(self.stored_layers()):
            for stream in ("k", "v"):
                for p in range(p0, n_pages):
                    key = self._slot_key(st, li, p, stream)
                    # a shared page is fetched at THIS holder's ladder
                    # assignment (the store's hint is the last re-ranker's)
                    keep_fn = (None if key.seq_id == rid
                               else lambda p=p: st.page_planes.get(p))
                    kt = key.astuple()
                    reactivate = []
                    for tier, cols in self._page_targets(key):
                        if tier.store.contains(key):
                            tier.engine.submit(make_fetch_job(
                                tier.store, self.stats, key, self._seq_key(tier, rid),
                                device_kv=self.device_kv, telemetry=self.telemetry,
                                rid=rid, keep_fn=keep_fn,
                            ))
                        elif (tier.engine.pending(kt, JobClass.KV_WRITE)
                              or tier.engine.pending(kt, JobClass.BACKGROUND)):
                            self.stats["kv_fetch_deferrals"] += 1
                        elif self._can_reactivate(st, p, ln):
                            reactivate.append((tier, cols))
                        else:
                            # ring: the window slid over part of the page's
                            # device rows; nothing left to re-compress, and
                            # the page dies shortly anyway
                            self.stats["kv_fetch_misses"] += 1
                    if reactivate:
                        self._reactivate(slot_id, key, reactivate)

    def _reactivate(self, slot_id: int, key: PageKey, targets) -> None:
        """An evicted page is needed again: queue a background re-compress
        from the device working set on ``targets`` at the plane count the
        ladder last assigned (charged once per tier, when the engine
        services it).  A ragged stored tail re-activates at its exact valid
        length."""
        st = self._slots[slot_id]
        t0 = key.page_idx * PAGE_TOKENS
        t1 = min(t0 + PAGE_TOKENS, st.stored_tokens)
        bits = self.slot_kv_bits(slot_id, t0, t1, slice(key.layer, key.layer + 1))
        (page,), (valid,) = self.encode_span(bits[0, ("k", "v").index(key.stream)])
        self.page_encodes["reactivations"] += 1
        self._submit_page_write(st, key, page, valid, JobClass.BACKGROUND, targets)

    # ---------------------------------------------------------------- ladder
    def _device_k_rows(self, slot_id: int, t0: int, t1: int) -> torch.Tensor:
        """Last-layer device keys for tokens [t0, t1), (t, Hkv, hd) bf16 —
        the quest ranking input, identical between layouts."""
        if self.device_kv != "bitplane":
            k = self._take_rows(self._cache["k"][-1, slot_id], 0, t0, t1)
            staged = self._staged_rows(slot_id, t0, t1)
            if staged is not None:
                # staged tokens (the q-proxy row ln - 1 too) live in the ring
                lo, r0, n = staged
                k = k.clone()
                k[lo - t0:lo - t0 + n] = self._cache["sk"][-1, slot_id, r0:r0 + n]
            return k
        pl = self._take_rows(self._cache["k_planes"][-1][:, slot_id], 1, t0, t1)
        return unpack_kv(pl, pl.shape[0], pl.shape[0])

    def _device_page(self, page_idx: int) -> int:
        """Device plane-map column holding this absolute page (ring layouts
        fold it modulo the window's page count)."""
        return page_idx

    def _set_device_row(self, slot_id: int, st: SlotState,
                        row: np.ndarray) -> None:
        """Write a slot's plane-map row to the device cache, skipping the
        transfer when it matches the last pushed row."""
        if st.device_row is not None and np.array_equal(st.device_row, row):
            return
        st.device_row = row
        # in place: the reference's planes.at[slot_id].set(row)
        self._cache["planes"][slot_id] = torch.as_tensor(row, device=self.device)
        if self.telemetry.enabled:  # only actual device writes, not re-syncs
            self.telemetry.on_plane_push(st.rid, slot_id)

    def _push_device_planes(self, slot_id: int, st: SlotState) -> None:
        """Publish the slot's ladder assignment into the device plane map,
        so the NEXT decode step's kernel reads exactly the planes the
        controller will charge.  Pages without an assignment (the growing
        tail, a dead ring prefix already pruned from ``page_planes``) stay
        at full precision."""
        if self.device_kv != "bitplane":
            return
        bits = self.tiers[0].store.spec.bits
        row = np.full(self._cache["planes"].shape[1], bits, np.int32)
        for p, keep in st.page_planes.items():
            if p >= st.live_from_page:
                row[self._device_page(p)] = keep
        self._set_device_row(slot_id, st, row)

    def _assign_ladder_planes(self, slot_id: int, ln: int) -> None:
        """Re-rank this slot's live full pages against the newest query proxy
        (the last-layer key at ln-1) and record the ladder's plane count on
        every stored page (all layers share the last layer's ranking).  A
        ragged stored tail page keeps full precision until it fills.  The
        per-page count is SNAPPED to the ladder's rung planes (nearest; ties
        keep the higher precision)."""
        ladder = self.cfg.ladder
        if ladder is None:
            return
        st = self._slots[slot_id]
        n_pages = ln // PAGE_TOKENS
        p0 = st.live_from_page
        if n_pages <= p0:
            return
        k_last = self._device_k_rows(slot_id, p0 * PAGE_TOKENS, n_pages * PAGE_TOKENS)
        kmin, kmax = page_minmax(k_last, PAGE_TOKENS)
        q_proxy = self._device_k_rows(slot_id, ln - 1, ln)[0]
        planes = assign_page_precision(quest_scores(q_proxy, kmin, kmax), ladder)
        mean_planes = planes.cpu().numpy().astype(np.float32).mean(axis=1)
        spec_bits = self.tiers[0].store.spec.bits
        rung_planes = sorted({min(spec_bits, max(1, p)) for _, p in ladder.rungs})
        for i, p in enumerate(range(p0, n_pages)):
            m = float(mean_planes[i])
            keep = min(rung_planes, key=lambda r: (abs(r - m), -r))
            st.page_planes[p] = keep
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    key = self._slot_key(st, li, p, stream)
                    for tier, _cols in self._page_targets(key):
                        tier.store.set_planes(key, keep)
        if self.telemetry.enabled:
            self.telemetry.on_ladder_rerank(st.rid, n_pages - p0)
        self._push_device_planes(slot_id, st)

    # ---------------------------------------------------------------- engine
    def tick(self) -> None:
        compute = self._weight_pass_pending
        self._weight_pass_pending = False
        if compute:
            # weight jobs enter the SAME lane window the step's KV traffic
            # contends for: the current pass, then the next pass's
            # prefetch-depth layers (the double buffer)
            for ws in self.streamers:
                ws.begin_pass()
        for tier in self.tiers:
            tier.engine.tick()
        if compute:
            # a current-pass layer the window could not service is a stall,
            # charged to modeled latency (engine_time_ns)
            for ws in self.streamers:
                ws.window_close()

    def backlog(self) -> int:
        """Queued engine jobs (eviction write-backs, deferred writes) — the
        drain loop services these before report()."""
        return sum(len(tier.engine.queue) for tier in self.tiers)

    def admit_pressure_ns(self) -> float:
        return max(tier.engine.pressure_ns() for tier in self.tiers)

    def engine_time_ns(self) -> float:
        """Modeled engine-clock time (the telemetry collector's second
        clock domain): the serviced-work watermark plus the cumulative
        weight-stream stall time (both monotone)."""
        base = max(tier.engine.clock.elapsed_ns for tier in self.tiers)
        stall = max((ws.counters["stall_ns"] for ws in self.streamers), default=0.0)
        return base + stall

    # ------------------------------------------------------------- reporting
    def note_peaks(self) -> None:
        fps = [tier.store.footprint() for tier in self.tiers]
        self.stats["kv_peak_stored_bytes"] = max(
            self.stats["kv_peak_stored_bytes"], sum(fp["stored_bytes"] for fp in fps))
        self.stats["kv_peak_logical_bytes"] = max(
            self.stats["kv_peak_logical_bytes"], sum(fp["logical_bytes"] for fp in fps))

    def report(self) -> dict:
        """Memory-tier half of the scheduler's report: pad-free logical vs
        stored/fetched bytes, eviction counters, the device bytes the decode
        kernels read, and the engine-limited numbers, summed over the tiers
        (one tier's engine report passes through unchanged)."""
        w_log = w_phys = r_log = r_phys = r_dev = 0
        evictions = evicted_bytes = resident = 0
        for tier in self.tiers:
            wl, wp = tier.controller.stats.kind_bytes("kv_write")
            rl, rp = tier.controller.stats.kind_bytes("kv_read")
            w_log, w_phys, r_log, r_phys = w_log + wl, w_phys + wp, r_log + rl, r_phys + rp
            r_dev += tier.controller.stats.kind_device_bytes("kv_read")
            fp = tier.store.footprint()
            evictions += fp["evictions"]
            evicted_bytes += fp["evicted_bytes"]
            resident += fp["stored_bytes"]
        s: dict = {
            "kv_logical_bytes": w_log,
            "kv_stored_bytes": w_phys,
            "kv_fetch_logical": r_log,
            "kv_fetch_physical": r_phys,
        }
        if w_log:
            s["kv_capacity_saving"] = 1 - w_phys / w_log
        if r_log:
            s["kv_bandwidth_saving"] = 1 - r_phys / r_log
        # device half of the bandwidth claim: bit-plane layout reads equal
        # the controller's plane-scaled kv_read; the dense layout reads the
        # full-precision logical bytes
        s["device_kv"] = self.device_kv
        s["device_bytes_read"] = self.stats["device_bytes_read"]
        s["kv_read_device_bytes"] = r_dev
        if r_log:
            s["kv_device_bandwidth_saving"] = \
                1 - self.stats["device_bytes_read"] / r_log
        s["kv_evictions"] = evictions
        s["kv_evicted_bytes"] = evicted_bytes
        s["kv_resident_stored_bytes"] = resident
        reports = [tier.engine.report() for tier in self.tiers]
        er = reports[0] if len(reports) == 1 else aggregate_engine_reports(reports)
        s["engine"] = er
        s["engine_utilization"] = er["utilization"]
        s["engine_modeled_latency_ns"] = er["modeled_latency_ns"]
        s["engine_deferred_jobs"] = er["deferred_job_steps"]
        s["engine_queue_depth_p99"] = er["queue_depth"]["p99"]
        s["admit_pressure_ns"] = self.admit_pressure_ns()
        total_sb = sum(er["serviced_bytes"].values())
        if total_sb:
            s["engine_utilization_by_class"] = {
                k: er["utilization"] * v / total_sb
                for k, v in er["serviced_bytes"].items()
            }
        # weight-side traffic (savings over exact block bytes, as Table III
        # quotes them, and the streamer's stalls) and shared-prefix traffic
        s["weights"] = self._weights_report()
        s["prefix"] = self._prefix_report()
        return s

    def _prefix_report(self) -> dict:
        pr: dict = {"enabled": self.prefix is not None}
        if self.prefix is None:
            return pr
        fps = [tier.store.footprint() for tier in self.tiers]
        matched = self.stats.get("prefix_tokens_matched", 0)
        prefilled = self.stats.get("prefill_tokens", 0)
        pr.update({
            "requests_matched": self.stats.get("prefix_requests_matched", 0),
            "tokens_matched": matched,
            "pages_matched": self.stats.get("prefix_pages_matched", 0),
            "bytes_deduplicated": self.stats.get("prefix_bytes_deduped", 0),
            "prefill_chunks_skipped": self.stats.get("prefill_chunks_skipped", 0),
            # matched tokens never prefill: the share of prompt work the
            # index absorbed
            "hit_ratio": (matched / (matched + prefilled)
                          if matched + prefilled else 0.0),
            "index_entries": len(self.prefix),
            "resident_shared_pages": sum(fp["shared_pages"] for fp in fps),
            "resident_shared_bytes": sum(fp["shared_stored_bytes"] for fp in fps),
            "bound_pages": sum(fp["bound_pages"] for fp in fps),
            "shared_evictions": sum(fp["shared_evictions"] for fp in fps),
        })
        return pr

    def _weights_report(self) -> dict:
        w: dict = {"mode": self.cfg.weight_stream}
        if not self.streamers:
            return w
        rl = rp = stored = logical = 0
        for tier in self.tiers:
            read_l, read_p = tier.controller.stats.kind_bytes("weight_read")
            rl += read_l
            rp += read_p
            fp = tier.controller.footprint()
            stored += fp["weights_stored"]
            logical += fp["weights_logical"]
        reps = [ws.report() for ws in self.streamers]
        w.update({
            "n_layers": reps[0]["n_layers"],
            "prefetch_depth": reps[0]["prefetch_depth"],
            "stored_bytes": stored,
            "logical_bytes": logical,
            # capacity: resident compressed footprint vs pad-free logical
            "capacity_saving": 1 - stored / logical if logical else 0.0,
            "read_logical_bytes": rl,
            "read_physical_bytes": rp,
            # bandwidth: what the bus moved for streamed reads vs what the
            # compute consumed (the paper's weight-side headline)
            "bandwidth_saving": 1 - rp / rl if rl else 0.0,
            "fetch_jobs": sum(r["fetch_jobs"] for r in reps),
            # every tier consumes the same step stream: per-tier values
            "passes_consumed": max(r["passes_consumed"] for r in reps),
            "passes_fetched": max(r["passes_fetched"] for r in reps),
            "stall_steps": max(r["stall_steps"] for r in reps),
            "stall_layers": sum(r["stall_layers"] for r in reps),
            "stall_ns": max(r["stall_ns"] for r in reps),
            "stall_fraction": max(r["stall_fraction"] for r in reps),
        })
        return w

    # ------------------------------------------------------------ accessors
    @property
    def store(self) -> CompressedKVStore:
        """Tier 0's store (a sharded backend has one per shard)."""
        return self.tiers[0].store

    @property
    def controller(self) -> MemoryController:
        return self.tiers[0].controller

    @property
    def engine(self) -> CompressionEngineRuntime:
        return self.tiers[0].engine
