"""Double-buffered layer-ahead weight prefetch through the memctl engine.

Streaming model (one "weight pass" per compute step — every prefill chunk
and decode token computed in a step reuses the same streamed layer
buffers, so weight bytes are charged exactly once per layer per step):

* ``begin_pass()`` — called by the backend right before the engine tick of
  a step that ran compute.  Submits one ``JobClass.WEIGHT_FETCH`` job per
  not-yet-prefetched layer of the CURRENT pass, then prefetches the first
  ``prefetch_depth`` layers of the NEXT pass so their decompresses overlap
  this step's matmuls (the double buffer; "LLM in a flash"-style windowed
  overlap).  Weight jobs share the lane budget with KV traffic: they beat
  KV writes but yield to decode-critical KV fetches.
* ``window_close()`` — called after the engine tick.  Any current-pass
  layer still not serviced is a stall: compute would have waited for the
  lane engine, so the residual drain time is charged to modeled latency
  (surfaced as ``stall_ns`` in ``report()["weights"]`` and added to the
  backend's engine time).

Job completion fns charge ``controller.account_weight_read`` per tensor at
modeled service time — the only place weight-read bytes enter the stats
(the reference enforces that with its ``accounting-weight-stream`` lint
rule).  A copy of the reference's ``weights/streamer.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from repro_torch.memctl import Job, JobClass


class WeightStreamer:
    """Streams one tier's :class:`CompressedWeightStore` through its
    :class:`CompressionEngineRuntime`."""

    def __init__(self, store, engine, telemetry=None,
                 prefetch_depth: Optional[int] = None, tier: int = 0):
        self.store = store
        self.engine = engine
        self.telemetry = telemetry
        self.tier = tier
        n = store.n_layers
        #: layers of the NEXT pass submitted during the current window;
        #: None = the whole next pass (full double buffer), 0 = no overlap
        self.prefetch_depth = n if prefetch_depth is None else max(
            0, min(int(prefetch_depth), n))
        self.passes_begun = 0
        self._jobs: Dict[Tuple[int, int], Job] = {}
        self._submitted: Set[Tuple[int, int]] = set()
        self._done: Set[Tuple[int, int]] = set()
        self.counters = {
            "fetch_jobs": 0,
            "fetched_logical_bytes": 0,
            "fetched_physical_bytes": 0,
            "stall_steps": 0,
            "stall_layers": 0,
            "stall_ns": 0.0,
        }

    # ------------------------------------------------------------- step hooks
    def begin_pass(self) -> None:
        p = self.passes_begun
        for li in range(self.store.n_layers):
            self._submit(p, li)
        self.passes_begun = p + 1
        for li in range(self.prefetch_depth):
            self._submit(p + 1, li)

    def window_close(self) -> float:
        """Charge stalls for the pass the step just computed; returns the
        ns charged (0.0 when every layer was ready in time)."""
        p = self.passes_begun - 1
        if p < 0:
            return 0.0
        pending = [
            li for li in range(self.store.n_layers)
            if (p, li) in self._submitted and (p, li) not in self._done
        ]
        ns = 0.0
        if pending:
            remaining = sum(
                self._jobs[(p, li)].remaining
                for li in pending if (p, li) in self._jobs
            )
            rate = self.engine.cfg.lanes * self.engine.cfg.lane_bytes_per_cycle
            ns = self.engine.clock.cycles_to_ns(-(-remaining // rate))
            c = self.counters
            c["stall_steps"] += 1
            c["stall_layers"] += len(pending)
            c["stall_ns"] += ns
            if self.telemetry is not None and self.telemetry.enabled:
                self.telemetry.on_weight_stall(self.tier, p, len(pending), ns)
        # prune bookkeeping for fully-drained past passes
        for key in [k for k in self._done if k[0] < p]:
            self._done.discard(key)
            self._submitted.discard(key)
        return ns

    # --------------------------------------------------------------- internal
    def _submit(self, p: int, li: int) -> None:
        if (p, li) in self._submitted:
            return
        self._submitted.add((p, li))
        lw = self.store.layer(li)

        def serviced(p=p, li=li, lw=lw):
            physical = 0
            for e in lw.entries:
                physical += self.store.controller.account_weight_read(e.key)
            self._done.add((p, li))
            self._jobs.pop((p, li), None)
            c = self.counters
            c["fetch_jobs"] += 1
            c["fetched_logical_bytes"] += lw.valid_logical_bytes
            c["fetched_physical_bytes"] += physical
            if self.telemetry is not None and self.telemetry.enabled:
                self.telemetry.on_weight_fetch(
                    self.tier, li, p, lw.valid_logical_bytes, physical,
                    self.engine.clock.now)

        job = Job(
            JobClass.WEIGHT_FETCH,
            lw.valid_logical_bytes,  # decompressed-side bytes, like KV plans
            fn=serviced,
            key=("wfetch", li),
            seq_id=None,  # never cancelled by request retirement
        )
        self._jobs[(p, li)] = job
        self.engine.submit(job)

    # ----------------------------------------------------------------- report
    def report(self) -> dict:
        c = dict(self.counters)
        n = self.store.n_layers
        c.update({
            "n_layers": n,
            "prefetch_depth": self.prefetch_depth,
            "passes_consumed": self.passes_begun,
            "passes_fetched": (c["fetch_jobs"] // n if n else 0),
            "stall_fraction": (c["stall_steps"] / self.passes_begun
                               if self.passes_begun else 0.0),
        })
        return c
