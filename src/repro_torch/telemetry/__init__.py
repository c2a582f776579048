"""Serving telemetry collector (copy of the reference's
``telemetry.collector``).  The Perfetto and Prometheus exporters are not
ported yet: they come with the 'rest of serving' slice (ROADMAP queue 1)."""

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
