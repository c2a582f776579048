"""Serving stack of the port: continuous batching over a compressed paged
KV tier, with bit-plane device caches read through the paged-attention
kernels."""

from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.sampler import SamplerConfig  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousScheduler,
    EngineConfig,
    Request,
    resolve_device,
)
