"""Prometheus text-format snapshot of the serving report + telemetry (a
copy of the reference's ``telemetry/prometheus.py``).

One call, one string in the Prometheus exposition format (text/plain
version 0.0.4) — the shape a scrape endpoint or a node-exporter textfile
collector ingests directly:

    repro_serving_decode_tokens_total 412
    repro_serving_ttft_wall_ns{quantile="p99"} 1.92e+07
    repro_serving_engine_utilization{tier="0"} 0.41

Scalar numbers from ``ContinuousScheduler.report()`` become gauges/counters
(``*_total`` suffix for monotone counters), the telemetry latency quantiles
become ``{quantile="..."}``-labelled series, and per-shard engine numbers
are labelled by tier.  Nested non-numeric report entries are skipped — the
snapshot is a metrics surface, not a serializer.
"""

from __future__ import annotations

import re
from typing import List

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: report() keys that are monotone counters (exported with _total suffix)
_COUNTERS = {
    "prefill_tokens", "decode_tokens", "prefill_chunks", "decode_steps",
    "requests_submitted", "requests_completed", "requests_truncated",
    "kv_reactivations", "kv_fetch_misses", "kv_fetch_deferrals",
    "engine_jobs_cancelled", "admits_deferred", "backpressure_steps",
    "kv_logical_bytes", "kv_stored_bytes", "kv_fetch_logical",
    "kv_fetch_physical", "kv_evictions", "kv_evicted_bytes",
    "device_bytes_read", "kv_read_device_bytes",
}


def _metric_name(key: str, prefix: str) -> str:
    name = _NAME_RE.sub("_", key).strip("_").lower()
    return f"{prefix}_{name}"


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    f = float(value)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prometheus_snapshot(report: dict, prefix: str = "repro_serving") -> str:
    """Render a ``ContinuousScheduler.report()`` dict (with or without the
    telemetry ``latency`` block) as Prometheus exposition text."""
    lines: List[str] = []

    def emit(key: str, value, labels: str = "", kind: str | None = None,
             help_text: str | None = None):
        name = _metric_name(key, prefix)
        kind = kind or ("counter" if key in _COUNTERS else "gauge")
        # HELP/TYPE once per metric name
        header = f"# TYPE {name} {kind}"
        if header not in lines:
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(header)
        lines.append(f"{name}{labels} {_fmt(value)}")

    for key, value in report.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            if key in _COUNTERS:
                emit(key + "_total", value, kind="counter")
            else:
                emit(key, value)
    latency = report.get("latency")
    if isinstance(latency, dict):
        for key, q in latency.items():
            if not isinstance(q, dict):
                continue
            for quant in ("p50", "p95", "p99"):
                if quant in q:
                    emit(key, q[quant],
                         labels=f'{{quantile="{quant}"}}',
                         kind="gauge",
                         help_text="telemetry span quantile")
            if "count" in q:
                emit(key + "_count", q["count"], kind="gauge")
    shards = report.get("shards")
    if isinstance(shards, list):
        for sh in shards:
            if not isinstance(sh, dict):
                continue
            tier = sh.get("shard", 0)
            for key, value in sh.items():
                if key != "shard" and isinstance(value, (int, float)):
                    emit("shard_" + key, value, labels=f'{{tier="{tier}"}}',
                         kind="gauge")
    telem = report.get("telemetry")
    if isinstance(telem, dict):
        for key, value in telem.items():
            if isinstance(value, (int, float)):
                emit("telemetry_" + key, value, kind="gauge")
    return "\n".join(lines) + "\n"
