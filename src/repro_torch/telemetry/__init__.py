"""Serving telemetry: request-lifecycle spans, memctl lane timelines, and
the Perfetto and Prometheus exporters (copies of the reference's
``telemetry`` package)."""

from repro_torch.telemetry.collector import (  # noqa: F401
    NULL_COLLECTOR,
    NullCollector,
    RequestSpan,
    Stamp,
    TelemetryCollector,
    TelemetryConfig,
    make_collector,
    quantiles,
)
from repro_torch.telemetry.perfetto import (  # noqa: F401
    build_trace_events,
    validate_trace,
    write_perfetto_trace,
)
from repro_torch.telemetry.prometheus import prometheus_snapshot  # noqa: F401
