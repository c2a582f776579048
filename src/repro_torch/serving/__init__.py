"""Serving stack of the port: continuous batching over a compressed paged
KV tier, with bit-plane device caches read through the paged-attention
kernels, shared-prefix pages and compressed weight streaming."""

from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.kv_cache import CompressedKVStore, PageEvictedError  # noqa: F401
from repro_torch.serving.sampler import SamplerConfig  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousScheduler,
    EngineConfig,
    Request,
    resolve_device,
)
from repro_torch.serving.traces import (  # noqa: F401
    DEFAULT_CLASSES,
    RequestClass,
    TraceItem,
    make_trace,
)
from repro_torch.telemetry import (  # noqa: F401
    TelemetryConfig,
    prometheus_snapshot,
    write_perfetto_trace,
)
