"""Single-device compressed paged tier behind the
:class:`~repro_torch.serving.backends.base.KVBackend` protocol."""

from __future__ import annotations

from repro_torch.serving.backends.base import KVBackend


class PagedBackend(KVBackend):
    """One :class:`MemTier` (controller + compressed store + lane engine),
    one device cache, full-attention page layout.  Every default in the
    base class IS this backend."""

    name = "paged"
