"""Memory-tier backends behind one serving API.

``EngineConfig.backend`` selects the policy; :func:`make_backend` is the
only constructor the scheduler uses.  The port has the paged tier; the ring
and sharded tiers of the reference come with a later slice.
"""

from repro_torch.serving.backends.base import KVBackend, MemTier, SlotState  # noqa: F401
from repro_torch.serving.backends.paged import PagedBackend

BACKENDS = {PagedBackend.name: PagedBackend}

#: backends the reference has that the port does not serve yet
_LATER = ("ring", "sharded")

__all__ = ["BACKENDS", "KVBackend", "MemTier", "PagedBackend", "SlotState",
           "make_backend"]


def make_backend(model, cfg, device, controller=None, stats=None,
                 telemetry=None) -> KVBackend:
    """Build the memory-tier backend ``cfg.backend`` names."""
    if cfg.backend in _LATER:
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported yet: the ring and sharded "
            f"tiers come with the 'ring and sharded backends' slice (ROADMAP "
            f"queue 1); the port serves backend='paged'"
        )
    try:
        cls = BACKENDS[cfg.backend]
    except KeyError:
        raise ValueError(
            f"unknown KV backend {cfg.backend!r}; available: {sorted(BACKENDS)}"
        ) from None
    return cls(model, cfg, device, controller=controller, stats=stats,
               telemetry=telemetry)
