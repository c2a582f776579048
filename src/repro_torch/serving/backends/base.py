"""``KVBackend``: the protocol between the continuous-batching scheduler
and the memory tier (port of the reference's ``serving/backends/base.py``,
single-device paged tier).

Protocol surface (what the scheduler calls — everything else is private):

========================  ===================================================
``ensure_cache()``        build/return the device decode cache
``cache`` (property)      get/set the device cache between model calls
``sync_lens(lens)``       publish the per-slot true lengths to the cache
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
controller and lane engine are host-side NumPy copies of the reference's.
Device->host copies carry bf16 as ``uint16`` bit patterns
(:func:`~repro_torch.core.bitplane.bf16_to_numpy`).

Not in this slice (each raises where it is asked for): the ring and sharded
backends, shared-prefix pages, compressed weight streaming and staged
decode caches.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.compression import default_codec
from repro_torch.core.bitplane import bf16_to_numpy
from repro_torch.core.compressed_store import StoreConfig
from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import (
    assign_page_precision,
    page_minmax,
    quest_scores,
)
from repro_torch.kernels.paged_attention.ops import unpack_kv
from repro_torch.memctl import CompressionEngineRuntime, Job, JobClass
from repro_torch.models.transformer import bitplane_cache_from_dense
from repro_torch.serving.kv_cache import (
    PAGE_TOKENS,
    CompressedKVStore,
    PageEvictedError,
    PageKey,
    iter_page_chunks,
)
from repro_torch.telemetry.collector import NULL_COLLECTOR

#: stat keys the backend mutates on the (shared) scheduler stats dict
BACKEND_STATS = (
    "kv_fetch_misses", "kv_fetch_deferrals", "kv_reactivations",
    "engine_jobs_cancelled", "kv_peak_stored_bytes", "kv_peak_logical_bytes",
    "device_bytes_read",
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
    #: last plane-map row pushed to the device cache (bit-plane layout) —
    #: lets per-token re-syncs skip the device write when nothing changed
    device_row: Optional[np.ndarray] = None


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
                   telemetry=None) -> Job:
    """Decode-critical fetch with SERVICE-TIME sizing.

    The plane count is resolved exactly once — by ``size_fn`` when the
    engine starts servicing the job — and the completion ``fn`` charges the
    controller's kv_read at that same count, so lane-pool bytes and the
    accounting never disagree across a ladder re-assignment (or an
    eviction) that lands between submit and service.

    The job also accumulates ``device_bytes_read``: a bit-plane device cache
    reads exactly the planes the ladder prescribes; a dense cache reads the
    full-precision page no matter what the ladder charged.
    """
    plan: dict = {}
    telemetry = telemetry if telemetry is not None else NULL_COLLECTOR

    def size() -> int:
        if not store.contains(key):
            store.note_miss()
            return 0  # evicted since submit; fn counts the scheduler miss
        nbytes, keep = store.fetch_plan(key)
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
            telemetry.on_fetch(key.seq_id, plan["device"], delta)

    return Job(JobClass.DECODE_FETCH, 0, fn=fn, key=key.astuple(),
               seq_id=seq_key, size_fn=size)


class KVBackend(abc.ABC):
    """Single-tier, full-attention, paged implementation of the protocol."""

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
        self.tiers: List[MemTier] = [MemTier(cfg, controller,
                                             cfg.max_stored_bytes,
                                             telemetry=self.telemetry)]
        self._cache = None
        self._slots: Dict[int, SlotState] = {}

    # ------------------------------------------------------------ validation
    @classmethod
    def check_model(cls, mcfg, cfg) -> None:
        """Raise when this backend cannot serve the model/config."""
        if mcfg.family != "dense":
            raise NotImplementedError(
                f"the port serves the dense family; {mcfg.family!r} comes "
                f"with the 'other model families' slice (ROADMAP queue 1 "
                f"item 8)"
            )
        if 0 < mcfg.attn_window < cfg.max_ctx:
            raise NotImplementedError(
                "sliding-window ring caches need backend='ring', which comes "
                "with the 'rest of serving' slice (ROADMAP queue 1 item 6)"
            )
        if mcfg.decode_staging > 0:
            raise NotImplementedError(
                f"decode_staging={mcfg.decode_staging}: staged decode caches "
                f"come with the 'rest of serving' slice (ROADMAP queue 1 "
                f"item 6)"
            )
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

    def sync_lens(self, lens) -> None:
        self._cache["len"] = torch.as_tensor(np.asarray(lens, np.int32),
                                             device=self.device)

    def max_prefill_bucket(self) -> int:
        return self.cfg.max_ctx

    def stored_layers(self) -> int:
        n_layers = self.mcfg.n_layers
        cap = self.cfg.store_layers
        return n_layers if cap is None else min(cap, n_layers)

    def slot_kv_host(self, slot_id: int, t0: int, t1: int):
        """Device->host copy of this slot's KV rows [t0, t1) for the stored
        layers, flattened to (L_stored, tokens, channels) raw bf16 bits
        (``uint16``).  The bit-plane layout unpacks at full precision first
        — packing is a bf16 bitcast, so the copy is bit-identical to the
        dense layout's."""
        ls = self.stored_layers()
        t = t1 - t0
        if self.device_kv == "bitplane":
            out = []
            for name in ("k_planes", "v_planes"):
                # (ls, bits, t, Hkv, hd8) -> planes first, layers as batch
                pl = self._cache[name][:ls, :, slot_id, t0:t1].movedim(1, 0)
                dense = unpack_kv(pl, pl.shape[0], pl.shape[0])
                out.append(bf16_to_numpy(dense.reshape(ls, t, -1)))
            return tuple(out)
        return tuple(
            bf16_to_numpy(self._cache[name][:ls, slot_id, t0:t1].reshape(ls, t, -1))
            for name in ("k", "v")
        )

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
        """Cancel the request's queued engine jobs and drop its pages.
        Eviction write-backs carry ``seq_id=None`` and survive.  Returns the
        number of cancelled jobs (also accumulated on the stats dict)."""
        cancelled = 0
        for tier in self.tiers:
            cancelled += tier.engine.cancel_seq(rid)
            tier.store.drop_sequence(rid)
        self.stats["engine_jobs_cancelled"] += cancelled
        self._slots.pop(slot_id, None)
        self._reset_device_planes(slot_id)
        return cancelled

    # ---------------------------------------------------------- page traffic
    def on_prefill_progress(self, slot_id: int, end: int, final: bool) -> None:
        """Prompt KV for tokens [0, end) is now on device: stream the newly
        completed pages to the tier (full pages as chunks land; on the
        final call also the ragged tail as an exact-length page), then
        assign ladder planes once the prompt is complete."""
        if not self.cfg.store_kv_compressed:
            return
        st = self._slots[slot_id]
        lo = st.stored_tokens
        hi = end if final else (end // PAGE_TOKENS) * PAGE_TOKENS
        if hi > lo:
            self._write_span(slot_id, lo, hi)
        if hi > st.stored_tokens:
            st.stored_tokens = hi
        if final:
            self._assign_ladder_planes(slot_id, end)

    def on_decode_token(self, slot_id: int, ln: int) -> None:
        """One decode token landed at position ln-1: store the page if it
        just filled (and re-rank the ladder), then queue this step's
        decode-critical fetch traffic for the slot."""
        if not self.cfg.store_kv_compressed:
            return
        st = self._slots[slot_id]
        if ln % PAGE_TOKENS == 0:  # a decode page just filled
            self._write_span(slot_id, ln - PAGE_TOKENS, ln)
            st.stored_tokens = ln
            self._assign_ladder_planes(slot_id, ln)
        self._account_step_fetch(slot_id)

    def _write_span(self, slot_id: int, t0: int, t1: int) -> None:
        """Page-split device KV rows [t0, t1) (t0 page-aligned; a ragged t1
        becomes an exact-length tail page) and queue one write job per page
        per stream per stored layer."""
        st = self._slots[slot_id]
        k_np, v_np = self.slot_kv_host(slot_id, t0, t1)
        first_page = t0 // PAGE_TOKENS
        for li in range(k_np.shape[0]):
            for stream, kv in (("k", k_np[li]), ("v", v_np[li])):
                for p, chunk, valid in iter_page_chunks(kv, first_page):
                    self._submit_page_write(
                        st, PageKey(st.rid, li, p, stream), chunk, valid
                    )

    def _submit_page_write(self, st: SlotState, key: PageKey,
                           chunk: np.ndarray, valid: int,
                           klass: JobClass = JobClass.KV_WRITE) -> None:
        """Queue one page's compress-and-store.  The chunk is captured at
        submit time (the token range is append-only); the store put — and
        its charged kv_write — happens when the engine services the job, at
        the ladder planes assigned by then.  ``valid`` < PAGE_TOKENS marks
        an exact-length tail page; the job is sized by its pad-free bytes.
        ``klass=BACKGROUND`` is a re-activation of an evicted page."""
        tier = self.tiers[0]

        def fn(store=tier.store):
            store.put_page(key, chunk, planes=st.page_planes.get(key.page_idx),
                           valid_tokens=valid)
            if klass == JobClass.BACKGROUND:
                self.stats["kv_reactivations"] += 1

        tier.engine.submit(Job(klass, chunk[:valid].nbytes, fn=fn,
                               key=key.astuple(), seq_id=st.rid))

    def _account_step_fetch(self, slot_id: int) -> None:
        """Queue this decode step's KV traffic for one slot as
        decode-critical fetch jobs: every stored-resident page at its ladder
        planes, sized at SERVICE time.  Evicted pages queue a background
        re-activation instead; pages whose write or re-activation is still
        queued are skipped (their ground truth is still the device working
        set)."""
        st = self._slots[slot_id]
        tier = self.tiers[0]
        n_pages = -(-st.stored_tokens // PAGE_TOKENS)
        for li in range(self.stored_layers()):
            for stream in ("k", "v"):
                for p in range(n_pages):
                    key = PageKey(st.rid, li, p, stream)
                    kt = key.astuple()
                    if tier.store.contains(key):
                        tier.engine.submit(make_fetch_job(
                            tier.store, self.stats, key, st.rid,
                            device_kv=self.device_kv, telemetry=self.telemetry,
                        ))
                    elif (tier.engine.pending(kt, JobClass.KV_WRITE)
                          or tier.engine.pending(kt, JobClass.BACKGROUND)):
                        self.stats["kv_fetch_deferrals"] += 1
                    else:
                        self._reactivate(slot_id, key)

    def _reactivate(self, slot_id: int, key: PageKey) -> None:
        """An evicted page is needed again: queue a background re-compress
        from the device working set at the plane count the ladder last
        assigned (charged once, when the engine services it).  A ragged
        stored tail re-activates at its exact valid length."""
        st = self._slots[slot_id]
        t0 = key.page_idx * PAGE_TOKENS
        valid = min(PAGE_TOKENS, st.stored_tokens - t0)
        k_np, v_np = self.slot_kv_host(slot_id, t0, t0 + valid)
        kv = k_np[key.layer] if key.stream == "k" else v_np[key.layer]
        _, page, valid = next(iter_page_chunks(kv))
        self._submit_page_write(st, key, page, valid, JobClass.BACKGROUND)

    # ---------------------------------------------------------------- ladder
    def _device_k_rows(self, slot_id: int, t0: int, t1: int) -> torch.Tensor:
        """Last-layer device keys for tokens [t0, t1), (t, Hkv, hd) bf16 —
        the quest ranking input, identical between layouts."""
        if self.device_kv != "bitplane":
            return self._cache["k"][-1, slot_id, t0:t1]
        pl = self._cache["k_planes"][-1][:, slot_id, t0:t1]
        return unpack_kv(pl, pl.shape[0], pl.shape[0])

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
        tail) stay at full precision."""
        if self.device_kv != "bitplane":
            return
        bits = self.tiers[0].store.spec.bits
        row = np.full(self._cache["planes"].shape[1], bits, np.int32)
        for p, keep in st.page_planes.items():
            row[p] = keep
        self._set_device_row(slot_id, st, row)

    def _assign_ladder_planes(self, slot_id: int, ln: int) -> None:
        """Re-rank this slot's full pages against the newest query proxy
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
        if n_pages <= 0:
            return
        k_last = self._device_k_rows(slot_id, 0, n_pages * PAGE_TOKENS)
        kmin, kmax = page_minmax(k_last, PAGE_TOKENS)
        q_proxy = self._device_k_rows(slot_id, ln - 1, ln)[0]
        planes = assign_page_precision(quest_scores(q_proxy, kmin, kmax), ladder)
        mean_planes = planes.cpu().numpy().astype(np.float32).mean(axis=1)
        spec_bits = self.tiers[0].store.spec.bits
        rung_planes = sorted({min(spec_bits, max(1, p)) for _, p in ladder.rungs})
        tier = self.tiers[0]
        for p in range(n_pages):
            m = float(mean_planes[p])
            keep = min(rung_planes, key=lambda r: (abs(r - m), -r))
            st.page_planes[p] = keep
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    tier.store.set_planes(PageKey(st.rid, li, p, stream), keep)
        if self.telemetry.enabled:
            self.telemetry.on_ladder_rerank(st.rid, n_pages)
        self._push_device_planes(slot_id, st)

    # ---------------------------------------------------------------- engine
    def tick(self) -> None:
        for tier in self.tiers:
            tier.engine.tick()

    def backlog(self) -> int:
        """Queued engine jobs (eviction write-backs, deferred writes) — the
        drain loop services these before report()."""
        return sum(len(tier.engine.queue) for tier in self.tiers)

    def admit_pressure_ns(self) -> float:
        return max(tier.engine.pressure_ns() for tier in self.tiers)

    def engine_time_ns(self) -> float:
        """Modeled engine-clock time (the telemetry collector's second
        clock domain)."""
        return max(tier.engine.clock.elapsed_ns for tier in self.tiers)

    # ------------------------------------------------------------- reporting
    def note_peaks(self) -> None:
        fp = self.tiers[0].store.footprint()
        self.stats["kv_peak_stored_bytes"] = max(
            self.stats["kv_peak_stored_bytes"], fp["stored_bytes"])
        self.stats["kv_peak_logical_bytes"] = max(
            self.stats["kv_peak_logical_bytes"], fp["logical_bytes"])

    def report(self) -> dict:
        """Memory-tier half of the scheduler's report: pad-free logical vs
        stored/fetched bytes, eviction counters, the device bytes the decode
        kernels read, and the engine-limited numbers."""
        tier = self.tiers[0]
        w_log, w_phys = tier.controller.stats.kind_bytes("kv_write")
        r_log, r_phys = tier.controller.stats.kind_bytes("kv_read")
        fp = tier.store.footprint()
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
        s["kv_read_device_bytes"] = tier.controller.stats.kind_device_bytes("kv_read")
        if r_log:
            s["kv_device_bandwidth_saving"] = \
                1 - self.stats["device_bytes_read"] / r_log
        s["kv_evictions"] = fp["evictions"]
        s["kv_evicted_bytes"] = fp["evicted_bytes"]
        s["kv_resident_stored_bytes"] = fp["stored_bytes"]
        er = tier.engine.report()
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
        return s

    # ------------------------------------------------------------ accessors
    @property
    def store(self) -> CompressedKVStore:
        return self.tiers[0].store

    @property
    def controller(self) -> MemoryController:
        return self.tiers[0].controller

    @property
    def engine(self) -> CompressionEngineRuntime:
        return self.tiers[0].engine
