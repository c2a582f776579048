"""Low-overhead serving telemetry: request-lifecycle spans + structured
engine events.

The serving stack can only quote end-of-run aggregates without this module —
there is no way to see *where* a token's time or bytes went.  The collector
threads through the whole path (scheduler, KV backends, memctl runtime) and
records three families of data:

* **Request-lifecycle spans.**  Every request gets one
  :class:`RequestSpan`: submit / admit / per-prefill-chunk / first-token /
  per-decode-commit / retire events, each stamped with the scheduler step,
  the host wall clock (``time.perf_counter_ns``) and the modeled engine
  clock (worst tier's :class:`~repro_torch.memctl.clock.EngineClock`, in ns) — so
  TTFT and per-token latency become first-class per-request measurements
  with p50/p95/p99 quantiles in *both* clock domains
  (:meth:`TelemetryCollector.latency_report`).

* **Structured step events.**  One record per scheduler step (occupancy,
  waiting queue, engine backlog), one per memctl engine tick per tier
  (serviced bytes, queue depth, deferred jobs, window cycles), plus
  eviction / ladder-re-rank / plane-map-push counts and per-lane busy
  intervals (the Perfetto lane timelines).

* **Per-request byte attribution.**  Every serviced decode fetch attributes
  its device-cache bytes AND its controller-side (plane-scaled) bytes to
  the owning request, so the span's ``device_bytes_read`` sums exactly to
  the run totals ``report()`` quotes (conformance-pinned on all three
  backends).

The hot path pays **one branch when disabled**: every instrumentation site
is guarded by ``if telemetry.enabled:`` and the default
:class:`NullCollector` is a frozen singleton with ``enabled = False`` —
no events, no stamps, no clock reads, tokens and byte counters bit-identical
to an un-instrumented run.

The reference's Perfetto and Prometheus exporters are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """``EngineConfig.telemetry`` payload (``None`` = disabled, the
    default — the serving hot path then pays one branch per site)."""

    enabled: bool = True
    #: record per-lane busy intervals from the memctl lane pool (the
    #: Perfetto lane timelines); each scheduled block is one record, so
    #: heavy runs can switch this off and keep the span machinery
    lane_timeline: bool = True
    #: cap on retained lane-block records; beyond it new blocks are counted
    #: as dropped (``summary()['lane_blocks_dropped']``) instead of growing
    #: the list without bound — never a silent truncation
    max_lane_blocks: int = 200_000


@dataclasses.dataclass
class Stamp:
    """One event's position in all three time domains."""

    step: int  # scheduler step counter
    wall_ns: int  # host wall clock (perf_counter_ns)
    engine_ns: float  # modeled memctl engine clock (worst tier)


@dataclasses.dataclass
class RequestSpan:
    """The full lifecycle of one request, as stamped events.

    A span is *closed* when ``retire`` is set; the collector moves it from
    ``open_spans`` to ``closed_spans`` — every submitted request closes
    exactly one span (lifecycle invariant, pinned in tests)."""

    rid: int
    prompt_tokens: int
    submit: Stamp
    admit: Optional[Stamp] = None
    slot: int = -1
    #: (stamp, chunk_start, chunk_end, final) per dispatched prefill chunk
    prefill_chunks: List[Tuple] = dataclasses.field(default_factory=list)
    first_token: Optional[Stamp] = None
    #: one stamp per COMMITTED decode token (host-materialized result)
    token_stamps: List[Stamp] = dataclasses.field(default_factory=list)
    retire: Optional[Stamp] = None
    new_tokens: int = 0
    truncated: bool = False
    #: device-cache bytes this request's serviced decode fetches moved
    #: (sums to ``report()['device_bytes_read']`` across closed spans)
    device_bytes_read: int = 0
    #: controller-side plane-scaled bytes for the same fetches (sums to
    #: ``ControllerStats.kind_device_bytes('kv_read')`` across tiers)
    controller_device_bytes: int = 0
    #: fetch jobs serviced for this request
    fetches: int = 0

    # ------------------------------------------------------------- derived
    def ttft_wall_ns(self) -> Optional[int]:
        if self.first_token is None:
            return None
        return self.first_token.wall_ns - self.submit.wall_ns

    def ttft_engine_ns(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token.engine_ns - self.submit.engine_ns

    def stamps_in_order(self) -> List[Stamp]:
        """Every stamp of the span in lifecycle order (the monotonicity
        invariant's witness list)."""
        out = [self.submit]
        if self.admit:
            out.append(self.admit)
        out.extend(s for s, *_ in self.prefill_chunks)
        if self.first_token:
            out.append(self.first_token)
        out.extend(self.token_stamps)
        if self.retire:
            out.append(self.retire)
        return out


def quantiles(vals: List[float]) -> dict:
    """p50/p95/p99 (nearest-rank) + mean/max/count over a sample."""
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                "mean": 0.0, "max": 0.0, "count": 0}
    v = sorted(vals)
    n = len(v)

    def pick(q: float) -> float:
        return float(v[min(n - 1, int(round(q * (n - 1))))])

    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99),
            "mean": float(sum(v) / n), "max": float(v[-1]), "count": n}


class NullCollector:
    """The disabled collector: ``enabled = False`` and nothing else.

    Instrumentation sites guard with ``if telemetry.enabled:`` so a
    disabled run never stamps a clock, allocates a record, or calls a
    method here — the attribute read IS the entire overhead.  The no-op
    methods exist only for direct callers (exporters fed a disabled
    collector fail loudly instead; see :func:`write_perfetto_trace`)."""

    enabled = False

    def __getattr__(self, name):
        # any collector method resolves to a no-op; misspelled attributes
        # on the REAL collector still raise there, which is where they run
        def _noop(*a, **kw):
            return None

        return _noop


#: process-wide disabled singleton (stateless, so sharing is safe)
NULL_COLLECTOR = NullCollector()


class TelemetryCollector:
    """The enabled collector: spans + structured events + attribution.

    Clock binding: the scheduler calls :meth:`bind_clocks` once, after the
    backend exists, handing over a step reader and an engine-clock reader
    (worst tier, ns).  Both are monotone, so every span's stamp list is
    monotone in both domains — the lifecycle invariant tests pin."""

    enabled = True

    def __init__(self, cfg: TelemetryConfig | None = None):
        self.cfg = cfg or TelemetryConfig()
        self._step_fn: Callable[[], int] = lambda: 0
        self._engine_ns_fn: Callable[[], float] = lambda: 0.0
        self._wall0: Optional[int] = None
        self.open_spans: Dict[int, RequestSpan] = {}
        self.closed_spans: List[RequestSpan] = []
        #: per-scheduler-step records ({step, wall_ns, engine_ns, active,
        #: decoding, waiting, backlog, ...})
        self.step_events: List[dict] = []
        #: per-(tier, engine-tick) records from the memctl runtime
        self.engine_steps: List[dict] = []
        #: (tier, lane, start_cycle, end_cycle, nbytes) lane busy intervals
        self.lane_blocks: List[Tuple[int, int, int, int, int]] = []
        #: (tier, layer, pass_idx, service_cycle, logical, physical) weight
        #: layer fetches — the streamer's marks on the lane timeline
        self.weight_events: List[Tuple[int, int, int, int, int, int]] = []
        self.counts: Dict[str, int] = {
            "evictions": 0, "eviction_bytes": 0,
            "ladder_reranks": 0, "plane_map_pushes": 0,
            "lane_blocks_dropped": 0, "fetches": 0,
            "weight_fetches": 0, "weight_stalls": 0,
        }

    # -------------------------------------------------------------- clocks
    def bind_clocks(self, step: Callable[[], int],
                    engine_ns: Callable[[], float]) -> None:
        self._step_fn = step
        self._engine_ns_fn = engine_ns

    def stamp(self) -> Stamp:
        wall = time.perf_counter_ns()
        if self._wall0 is None:
            self._wall0 = wall
        return Stamp(self._step_fn(), wall, self._engine_ns_fn())

    @property
    def wall_epoch_ns(self) -> int:
        """First stamp's wall time — the trace exporters' time origin."""
        return self._wall0 if self._wall0 is not None else 0

    # --------------------------------------------------- request lifecycle
    def on_submit(self, rid: int, prompt_tokens: int) -> None:
        self.open_spans[rid] = RequestSpan(
            rid=rid, prompt_tokens=prompt_tokens, submit=self.stamp()
        )

    def on_admit(self, rid: int, slot: int) -> None:
        sp = self.open_spans.get(rid)
        if sp is not None:
            sp.admit = self.stamp()
            sp.slot = slot

    def on_prefill_chunk(self, rid: int, start: int, end: int,
                         final: bool) -> None:
        sp = self.open_spans.get(rid)
        if sp is not None:
            sp.prefill_chunks.append((self.stamp(), start, end, final))

    def on_first_token(self, rid: int) -> None:
        sp = self.open_spans.get(rid)
        if sp is not None:
            sp.first_token = self.stamp()

    def on_decode_commit(self, rid_slots: List[Tuple[int, int]]) -> None:
        """One batched decode step committed: stamp every slot's new token
        with ONE shared stamp (they materialized together)."""
        st = self.stamp()
        for rid, _slot in rid_slots:
            sp = self.open_spans.get(rid)
            if sp is not None:
                sp.token_stamps.append(st)

    def on_retire(self, rid: int, new_tokens: int, truncated: bool) -> None:
        sp = self.open_spans.pop(rid, None)
        if sp is None:
            return
        sp.retire = self.stamp()
        sp.new_tokens = new_tokens
        sp.truncated = truncated
        self.closed_spans.append(sp)

    # --------------------------------------------------- byte attribution
    def on_fetch(self, rid: int, device_bytes: int,
                 controller_device_bytes: int) -> None:
        """A decode fetch for request ``rid`` was serviced by the engine:
        attribute its bytes to the owning span (fetch jobs are cancelled at
        retire, so the span is always still open here)."""
        sp = self.open_spans.get(rid)
        self.counts["fetches"] += 1
        if sp is not None:
            sp.device_bytes_read += device_bytes
            sp.controller_device_bytes += controller_device_bytes
            sp.fetches += 1

    # -------------------------------------------------- backend structure
    def on_eviction(self, tier: int, nbytes: int) -> None:
        self.counts["evictions"] += 1
        self.counts["eviction_bytes"] += nbytes

    def on_ladder_rerank(self, rid: int, n_pages: int) -> None:
        self.counts["ladder_reranks"] += 1

    def on_plane_push(self, rid: int, slot: int) -> None:
        """An actual device plane-map row write (unchanged rows skip the
        transfer and are NOT counted — the count is real device traffic)."""
        self.counts["plane_map_pushes"] += 1

    # ------------------------------------------------------ weight stream
    def on_weight_fetch(self, tier: int, layer: int, pass_idx: int,
                        logical: int, physical: int, cycle: int) -> None:
        """A weight-stream layer fetch was serviced by the lane engine
        (stamped with its service cycle, so it lands on the lane timeline
        next to the KV blocks it contended with)."""
        self.counts["weight_fetches"] += 1
        if self.cfg.lane_timeline:
            self.weight_events.append(
                (tier, layer, pass_idx, cycle, logical, physical)
            )

    def on_weight_stall(self, tier: int, pass_idx: int, layers: int,
                        ns: float) -> None:
        """Compute finished a step before the lane window delivered every
        layer of its weight pass — the residual drain is charged to
        modeled latency."""
        self.counts["weight_stalls"] += 1

    # ----------------------------------------------------- engine / lanes
    def on_engine_step(self, tier: int, record: dict) -> None:
        record["tier"] = tier
        self.engine_steps.append(record)

    def on_lane_block(self, tier: int, lane: int, start_cycle: int,
                      end_cycle: int, nbytes: int) -> None:
        if not self.cfg.lane_timeline:
            return
        if len(self.lane_blocks) >= self.cfg.max_lane_blocks:
            self.counts["lane_blocks_dropped"] += 1
            return
        self.lane_blocks.append((tier, lane, start_cycle, end_cycle, nbytes))

    # ------------------------------------------------------ scheduler step
    def on_step(self, record: dict) -> None:
        st = self.stamp()
        record.update(step=st.step, wall_ns=st.wall_ns,
                      engine_ns=st.engine_ns)
        self.step_events.append(record)

    # ---------------------------------------------------------- reporting
    def latency_report(self) -> dict:
        """TTFT and per-output-token latency quantiles over closed spans,
        in both the wall clock and the modeled engine clock."""
        ttft_w: List[float] = []
        ttft_e: List[float] = []
        tpot_w: List[float] = []
        tpot_e: List[float] = []
        queue_w: List[float] = []
        for sp in self.closed_spans:
            if sp.first_token is not None:
                ttft_w.append(sp.first_token.wall_ns - sp.submit.wall_ns)
                ttft_e.append(sp.first_token.engine_ns - sp.submit.engine_ns)
            if sp.admit is not None:
                queue_w.append(sp.admit.wall_ns - sp.submit.wall_ns)
            prev = sp.first_token
            for st in sp.token_stamps:
                if prev is not None:
                    tpot_w.append(st.wall_ns - prev.wall_ns)
                    tpot_e.append(st.engine_ns - prev.engine_ns)
                prev = st
        return {
            "requests": len(self.closed_spans),
            "ttft_wall_ns": quantiles(ttft_w),
            "ttft_engine_ns": quantiles(ttft_e),
            "tpot_wall_ns": quantiles(tpot_w),
            "tpot_engine_ns": quantiles(tpot_e),
            "queue_wall_ns": quantiles(queue_w),
        }

    def attribution_report(self) -> dict:
        """Per-request byte attribution (closed spans) + the open remainder
        — the sums the tests pin against the controller
        totals."""
        per_request = {
            sp.rid: {"device_bytes_read": sp.device_bytes_read,
                     "controller_device_bytes": sp.controller_device_bytes,
                     "fetches": sp.fetches}
            for sp in self.closed_spans
        }
        for rid, sp in self.open_spans.items():
            per_request[rid] = {
                "device_bytes_read": sp.device_bytes_read,
                "controller_device_bytes": sp.controller_device_bytes,
                "fetches": sp.fetches,
            }
        return {
            "per_request": per_request,
            "device_bytes_read": sum(
                v["device_bytes_read"] for v in per_request.values()),
            "controller_device_bytes": sum(
                v["controller_device_bytes"] for v in per_request.values()),
        }

    def summary(self) -> dict:
        return {
            "spans_open": len(self.open_spans),
            "spans_closed": len(self.closed_spans),
            "steps_recorded": len(self.step_events),
            "engine_steps_recorded": len(self.engine_steps),
            "lane_blocks": len(self.lane_blocks),
            **self.counts,
        }


def make_collector(cfg: TelemetryConfig | None):
    """The one constructor the serving stack uses: ``None`` (or an
    explicitly disabled config) -> the shared :data:`NULL_COLLECTOR`."""
    if cfg is None or not cfg.enabled:
        return NULL_COLLECTOR
    return TelemetryCollector(cfg)
