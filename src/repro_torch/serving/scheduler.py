"""Continuous-batching scheduler over the KV memory tier (port of the
reference's ``serving/scheduler.py``, bucketed prefill).

* **Admission queue + slot map.**  ``submit()`` enqueues requests; every
  ``step()`` admits waiting requests into free slots, advances prefill
  chunks, runs ONE batched decode step over all decoding slots, and
  retires requests that hit their own ``max_new_tokens``.
* **Bucketed chunked prefill.**  Prompts are processed in page-aligned
  chunks whose sizes come from a power-of-two bucket set; each chunk
  appends directly into the slot's rows and ``cache["len"]`` holds the TRUE
  prompt length, so no pad token is ever attended to, stored, ranked or
  charged.  While other slots decode, a joining prompt advances
  ``prefill_chunks_per_step`` chunks per step.
* **Memory tier.**  Every page write, decode fetch, eviction
  re-activation, ladder assignment, retirement cleanup, engine tick and
  savings report goes through the :class:`~.backends.KVBackend`.
* **Device.**  The model runs on one torch device, CUDA unless the caller
  passes ``device="cpu"``; without a GPU and without that argument the
  scheduler raises instead of moving to the CPU.

Not in this slice: ``prefill_mode="padded"``, shared-prefix pages,
compressed weight streaming and the ring/sharded backends — each raises
where it is asked for.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.device import resolve_device
from repro_torch.memctl import MemCtlConfig
from repro_torch.serving.backends import make_backend
from repro_torch.serving.kv_cache import PAGE_TOKENS
from repro_torch.serving.sampler import SamplerConfig, sample, sample_slots
from repro_torch.telemetry.collector import TelemetryConfig, make_collector


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: retired because the context window filled before max_new_tokens
    truncated: bool = False
    #: per-request sampling seed (None = the scheduler's base seed)
    rng_seed: Optional[int] = None
    #: rejected at submit by the load-shedding policy
    shed: bool = False
    shed_reason: str = ""
    arrival_step: int = -1  # step submit() saw it
    admit_step: int = -1  # step it won a slot
    finish_step: int = -1  # step it retired


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's ``EngineConfig`` fields that this slice serves."""

    max_batch: int = 8
    max_ctx: int = 512
    sampler: SamplerConfig = SamplerConfig()
    ladder: Optional[PrecisionLadder] = None  # None = full precision
    store_kv_compressed: bool = True
    #: compressed-tier byte budget (None = unbounded)
    max_stored_bytes: Optional[int] = None
    #: cap on layers written through the compressed store (None = all)
    store_layers: Optional[int] = 4
    #: KV-tier codec ('lz4' | 'zstd'); None = default_codec()
    codec: Optional[str] = None
    #: (de)compression-engine geometry + per-step service window
    engine: MemCtlConfig = MemCtlConfig()
    #: only 'bucketed' is ported
    prefill_mode: str = "bucketed"
    #: chunks each mid-prefill slot advances per step while others decode
    prefill_chunks_per_step: int = 1
    #: base sampling seed (temperature > 0 only)
    rng_seed: int = 0
    #: memory-tier policy: only 'paged' is ported
    backend: str = "paged"
    #: device KV layout: 'dense' bf16 rows, or 'bitplane' packed uint8
    #: planes read through the paged-attention kernels at the ladder's
    #: plane counts
    device_kv: str = "dense"
    #: bit-plane decode strategy: 'fused' (one kernel launch per layer) or
    #: 'rung' (one launch per distinct plane count, partials merged)
    decode_kernel: str = "fused"
    #: defer admits while the engine's modeled latency lags by more (ns)
    admit_latency_ns_max: Optional[float] = None
    #: reject requests at submit while the backlog exceeds this (ns)
    shed_latency_ns_max: Optional[float] = None
    #: shared-prefix pages: not ported yet, must stay False
    prefix_sharing: bool = False
    #: serving telemetry collector (None = the no-op null collector)
    telemetry: Optional[TelemetryConfig] = None
    #: weight-side streaming: only 'resident' is ported
    weight_stream: str = "resident"


@dataclasses.dataclass
class _Slot:
    req: Request
    pending: int  # next token to feed the decoder (already sampled)
    prompt: np.ndarray  # (S,) int32 — exact length, never padded
    seed: int = 0  # sampling stream seed (with the rid)
    draws: int = 0  # tokens sampled so far from this stream
    prefill_pos: int = 0  # prompt tokens already appended to the slot rows
    prefilling: bool = True  # still consuming prompt chunks (no decode yet)


def prefill_buckets(max_ctx: int) -> List[int]:
    """Power-of-two chunk sizes [PAGE_TOKENS, 2*PAGE_TOKENS, ... <= max_ctx]."""
    out = []
    b = PAGE_TOKENS
    while b <= max_ctx:
        out.append(b)
        b *= 2
    return out or [max_ctx]


def next_chunk(rem: int, buckets: List[int]) -> tuple:
    """(bucket, real) for the next prefill chunk of a prompt with ``rem``
    tokens left: the largest bucket that fits, or the smallest bucket
    right-padded for the ragged tail."""
    fit = [b for b in buckets if b <= rem]
    bucket = fit[-1] if fit else buckets[0]
    return bucket, min(bucket, rem)


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice "
        f"(ROADMAP queue 1)"
    )


class ContinuousScheduler:
    """Admission queue + slot map + in-flight join/retire serving loop.

    All memory-tier traffic flows through ``self.backend``; the scheduler
    holds no store, controller or engine and passes the device cache
    between the model's prefill-chunk and decode calls."""

    def __init__(self, model, params, cfg: EngineConfig, device=None,
                 controller: MemoryController | None = None):
        if cfg.prefill_mode != "bucketed":
            if cfg.prefill_mode == "padded":
                raise _not_ported("prefill_mode='padded'", "'rest of serving'")
            raise ValueError(f"prefill_mode must be 'bucketed', got {cfg.prefill_mode!r}")
        if cfg.decode_kernel not in ("fused", "rung"):
            raise ValueError(
                f"decode_kernel must be 'fused' or 'rung', got {cfg.decode_kernel!r}")
        if cfg.prefix_sharing:
            raise _not_ported("prefix_sharing", "'rest of serving'")
        if cfg.weight_stream != "resident":
            if cfg.weight_stream == "compressed":
                raise _not_ported("weight_stream='compressed'", "'rest of serving'")
            raise ValueError(f"weight_stream must be 'resident', got {cfg.weight_stream!r}")
        if cfg.max_ctx % PAGE_TOKENS != 0:
            # a ragged final bucket near the cache end would overrun it;
            # page-multiple max_ctx makes that unreachable
            raise ValueError(
                f"bucketed prefill needs max_ctx to be a multiple of "
                f"PAGE_TOKENS ({PAGE_TOKENS}), got {cfg.max_ctx}")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(
                f"params live on {table.device} but the scheduler runs on "
                f"{self.device}; move them first")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.step_count = 0
        self.stats: Dict[str, float] = {
            "prefill_tokens": 0, "decode_tokens": 0, "prefill_chunks": 0,
            "requests_submitted": 0, "requests_completed": 0,
            "requests_truncated": 0,
            "decode_steps": 0, "decode_batch_occupancy": 0.0,
            "kv_reactivations": 0,
            "kv_fetch_misses": 0, "kv_fetch_deferrals": 0,
            "engine_jobs_cancelled": 0,
            "kv_peak_stored_bytes": 0, "kv_peak_logical_bytes": 0,
            "admits_deferred": 0, "backpressure_steps": 0,
            "requests_shed": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
        }
        self.telemetry = make_collector(cfg.telemetry)
        self.backend = make_backend(model, cfg, self.device,
                                    controller=controller, stats=self.stats,
                                    telemetry=self.telemetry)
        if self.telemetry.enabled:
            self.telemetry.bind_clocks(lambda: self.step_count,
                                       self.backend.engine_time_ns)
        self._keeps = self.backend.device_keeps()
        self._buckets = prefill_buckets(
            min(cfg.max_ctx, self.backend.max_prefill_bucket()))
        self._waiting: Deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * cfg.max_batch
        self._lens = np.zeros(cfg.max_batch, np.int32)

    # ------------------------------------------------------------------ queue
    def submit(self, req: Request, rng_seed: int | None = None) -> None:
        if rng_seed is not None:
            req.rng_seed = rng_seed
        if len(req.prompt) < 1 or len(req.prompt) + 1 > self.cfg.max_ctx:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens leaves "
                f"no decode room — exceeds max_ctx {self.cfg.max_ctx}")
        req.arrival_step = self.step_count
        lim = self.cfg.shed_latency_ns_max
        if lim is not None:
            pressure = self.backend.admit_pressure_ns()
            if pressure > lim:
                req.done = True
                req.shed = True
                req.shed_reason = (
                    f"admission rejected: modeled engine backlog "
                    f"{pressure:.0f}ns exceeds shed_latency_ns_max {lim:.0f}ns")
                req.finish_step = self.step_count
                self.stats["requests_shed"] += 1
                return
        self._waiting.append(req)
        self.stats["requests_submitted"] += 1
        if self.telemetry.enabled:
            self.telemetry.on_submit(req.rid, len(req.prompt))

    @property
    def active(self) -> int:
        """Occupied slots (prefilling or decoding)."""
        return sum(s is not None for s in self._slots)

    @property
    def decoding(self) -> int:
        """Slots past prefill, generating tokens."""
        return sum(s is not None and not s.prefilling for s in self._slots)

    def has_work(self) -> bool:
        return (bool(self._waiting) or self.active > 0
                or self.backend.backlog() > 0)

    # ------------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """Admit -> prefill chunks -> one batched decode step -> flush
        prefill storage -> commit decode -> engine tick -> retire.  Returns
        the requests retired this step.  The backend's host-side page
        streaming for this step's prefill chunks runs after the decode step
        is dispatched, as in the reference."""
        self._admit_tick()
        progressed = self._prefill_tick()
        if self.decoding == 0:
            self._flush_prefill_progress(progressed)
            self.backend.tick()
            self._note_step()
            self.step_count += 1
            return []
        pending_decode = self._decode_dispatch()
        self._flush_prefill_progress(progressed)
        self._decode_commit(pending_decode)
        self.backend.tick()
        if self.cfg.store_kv_compressed:
            self.backend.note_peaks()
        self._note_step()
        self.step_count += 1
        return self._retire_finished()

    def _note_step(self) -> None:
        if self.telemetry.enabled:
            self.telemetry.on_step({
                "active": self.active, "decoding": self.decoding,
                "waiting": len(self._waiting),
                "backlog": self.backend.backlog(),
            })

    def _flush_prefill_progress(self, progressed) -> None:
        for slot_id, end, final in progressed:
            self.backend.on_prefill_progress(slot_id, end, final)

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            done.extend(self.step())
        return done

    # -------------------------------------------------------------- admission
    def _admit_tick(self) -> None:
        """Fill free slots from the waiting queue, unless the engine's
        modeled latency lags past ``admit_latency_ns_max``."""
        if not self._waiting:
            return
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return
        lim = self.cfg.admit_latency_ns_max
        if lim is not None and self.backend.admit_pressure_ns() > lim:
            self.stats["admits_deferred"] += min(len(free), len(self._waiting))
            self.stats["backpressure_steps"] += 1
            return
        for slot_id in free:
            if not self._waiting:
                break
            self._admit(self._waiting.popleft(), slot_id)

    def _admit(self, req: Request, slot_id: int) -> None:
        self.backend.ensure_cache()
        seed = req.rng_seed if req.rng_seed is not None else self.cfg.rng_seed
        self._slots[slot_id] = _Slot(
            req=req, pending=-1, prompt=np.asarray(req.prompt, np.int32),
            seed=seed)
        self._lens[slot_id] = 0
        self.backend.bind_slot(slot_id, req.rid)
        req.admit_step = self.step_count
        if self.telemetry.enabled:
            self.telemetry.on_admit(req.rid, slot_id)

    def _prefill_tick(self) -> List[tuple]:
        """Advance every mid-prefill slot: ``prefill_chunks_per_step``
        chunks while other slots decode, the whole prompt otherwise.
        Returns the (slot_id, end, final) progress events to flush."""
        progressed: List[tuple] = []
        decode_live = self.decoding > 0
        for slot_id, slot in enumerate(self._slots):
            if slot is None or not slot.prefilling:
                continue
            budget = (max(1, self.cfg.prefill_chunks_per_step)
                      if decode_live else len(slot.prompt))
            while slot.prefilling and budget > 0:
                self._prefill_chunk_once(slot_id, progressed)
                budget -= 1
        return progressed

    def _prefill_chunk_once(self, slot_id: int, progressed: List[tuple]) -> None:
        """Run ONE bucketed chunk of this slot's prompt, appending it into
        the slot's cache rows.  Only the final chunk's logits are sampled."""
        slot = self._slots[slot_id]
        start = slot.prefill_pos
        bucket, real = next_chunk(len(slot.prompt) - start, self._buckets)
        tokens = np.empty(bucket, np.int64)
        tokens[:real] = slot.prompt[start:start + real]
        if real < bucket:  # ragged tail: pad value is irrelevant (masked)
            tokens[real:] = slot.prompt[-1]

        t0 = time.time()
        logits, cache = self.model.prefill_chunk(
            self.params, torch.as_tensor(tokens[None], device=self.device),
            self.backend.cache, slot_id, start, real - 1)
        self.backend.cache = cache
        self.stats["prefill_s"] += time.time() - t0
        self.stats["prefill_tokens"] += real
        self.stats["prefill_chunks"] += 1

        slot.prefill_pos = start + real
        self._lens[slot_id] = slot.prefill_pos
        final = slot.prefill_pos >= len(slot.prompt)
        progressed.append((slot_id, slot.prefill_pos, final))
        if self.telemetry.enabled:
            self.telemetry.on_prefill_chunk(slot.req.rid, start,
                                            slot.prefill_pos, final)
        if final:
            slot.prefilling = False
            slot.pending = self._first_token(slot, logits)
            if self.telemetry.enabled:
                self.telemetry.on_first_token(slot.req.rid)

    def _first_token(self, slot: _Slot, logits) -> int:
        """Draw 0 of the slot's own stream (greedy = argmax)."""
        tok = sample(logits, self.cfg.sampler, slot.seed, slot.req.rid, 0)
        slot.draws = 1
        return int(tok[0])

    # ----------------------------------------------------------------- decode
    def _decode_dispatch(self):
        """Launch one batched decode step + sampling; returns the pending
        device result without waiting for it, so the host-side prefill
        storage flush overlaps the device work."""
        b = self.cfg.max_batch
        tok = np.zeros(b, np.int64)
        seeds = np.zeros(b, np.int64)
        rids = np.zeros(b, np.int64)
        draws = np.zeros(b, np.int64)
        for i, slot in enumerate(self._slots):
            if slot is not None and not slot.prefilling:
                tok[i] = slot.pending
                seeds[i], rids[i], draws[i] = slot.seed, slot.req.rid, slot.draws
            # idle or mid-prefill rows decode a dummy token: its k/v lands
            # at the row's own next position, masked for every real query
            # and overwritten by the next prefill chunk or admission
        self.backend.sync_lens(self._lens)

        t0 = time.time()
        logits, cache = self.model.decode(
            self.params, torch.as_tensor(tok, device=self.device),
            self.backend.cache, keeps=self._keeps,
            decode_kernel=self.cfg.decode_kernel)
        self.backend.cache = cache
        nxt = sample_slots(seeds, rids, draws, logits, self.cfg.sampler)
        return nxt, t0

    def _decode_commit(self, pending) -> None:
        """Wait for the dispatched decode step (one host sync per step) and
        run its bookkeeping: outputs, lengths, per-slot page traffic."""
        nxt_dev, t0 = pending
        nxt = nxt_dev.cpu().numpy()
        self.stats["decode_s"] += time.time() - t0

        n_dec = self.decoding
        self.stats["decode_steps"] += 1
        self.stats["decode_batch_occupancy"] += n_dec / self.cfg.max_batch
        live = self.telemetry.enabled
        committed: List[tuple] = []
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            slot.req.output.append(slot.pending)
            slot.pending = int(nxt[i])
            slot.draws += 1
            self._lens[i] += 1
            self.stats["decode_tokens"] += 1
            if live:
                committed.append((slot.req.rid, i))
            self.backend.on_decode_token(i, int(self._lens[i]))
        if live and committed:
            self.telemetry.on_decode_commit(committed)

    # ----------------------------------------------------------------- retire
    def _retire_finished(self) -> List[Request]:
        done = []
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            r = slot.req
            hit_ctx = int(self._lens[i]) >= self.cfg.max_ctx
            if len(r.output) >= r.max_new_tokens or hit_ctx:
                r.done = True
                if len(r.output) < r.max_new_tokens:
                    r.truncated = True
                    self.stats["requests_truncated"] += 1
                r.finish_step = self.step_count
                self.backend.retire(i, r.rid)
                self._slots[i] = None
                self._lens[i] = 0
                self.stats["requests_completed"] += 1
                if self.telemetry.enabled:
                    self.telemetry.on_retire(r.rid, len(r.output), r.truncated)
                done.append(r)
        return done

    # ----------------------------------------------------------------- report
    def report(self) -> dict:
        s = dict(self.stats)
        s.update(self.backend.report())
        if s["decode_s"]:
            s["decode_tok_per_s"] = s["decode_tokens"] / s["decode_s"]
        if s["decode_steps"]:
            s["mean_batch_occupancy"] = (
                s["decode_batch_occupancy"] / s["decode_steps"])
        n = s["requests_completed"]
        if n:
            per = 1000.0 / n
            s["per_1k_requests"] = {
                "kv_stored_bytes": s["kv_stored_bytes"] * per,
                "kv_logical_bytes": s["kv_logical_bytes"] * per,
                "kv_fetch_physical": s["kv_fetch_physical"] * per,
                "kv_fetch_logical": s["kv_fetch_logical"] * per,
                "kv_evicted_bytes": s["kv_evicted_bytes"] * per,
                "decode_tokens": s["decode_tokens"] * per,
                "requests_truncated": s["requests_truncated"] * per,
                "admits_deferred": s["admits_deferred"] * per,
                "requests_shed": s["requests_shed"] * per,
            }
        if self.telemetry.enabled:
            s["latency"] = self.telemetry.latency_report()
            s["telemetry"] = self.telemetry.summary()
        return s
