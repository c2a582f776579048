"""Memory-tier backends behind one serving API.

``EngineConfig.backend`` selects the policy; :func:`make_backend` is the
only constructor the scheduler uses: ``"paged"`` (one compressed paged
tier), ``"sharded"`` (per-shard tiers, pages routed by KV-head or sequence
ownership) and ``"ring"`` (per-slot sliding-window rings).
"""

from repro_torch.serving.backends.base import KVBackend, MemTier, SlotState  # noqa: F401
from repro_torch.serving.backends.paged import PagedBackend
from repro_torch.serving.backends.ring import RingBackend
from repro_torch.serving.backends.sharded import ShardedBackend

BACKENDS = {
    PagedBackend.name: PagedBackend,
    ShardedBackend.name: ShardedBackend,
    RingBackend.name: RingBackend,
}

__all__ = ["BACKENDS", "KVBackend", "MemTier", "PagedBackend", "RingBackend",
           "ShardedBackend", "SlotState", "make_backend"]


def make_backend(model, cfg, device, controller=None, stats=None,
                 telemetry=None) -> KVBackend:
    """Build the memory-tier backend ``cfg.backend`` names."""
    try:
        cls = BACKENDS[cfg.backend]
    except KeyError:
        raise ValueError(
            f"unknown KV backend {cfg.backend!r}; available: {sorted(BACKENDS)}"
        ) from None
    return cls(model, cfg, device, controller=controller, stats=stats,
               telemetry=telemetry)
