"""Sharded-KV serving tier (port of the reference's
``serving/backends/sharded.py``): per-shard compressed store, controller
and lane engine, with pages routed by KV-head ownership.

The route comes from the owner rule the reference's runtime uses to shard
decode caches (``runtime/sharding.py``: ``_kv_spec`` / ``cache_pspecs``),
here :func:`kv_cache_owner`, a plain function of the cache shape and the
shard count:

* the KV-head axis divides the shard count -> **head routing**: every page
  splits into per-shard channel slices (each shard compresses, stores,
  fetches and re-activates its own heads' slice of every page; the page is
  transformed once and each shard takes its channels' encoding,
  :meth:`~repro_torch.core.compressed_store.EncodedKV.columns`);
* otherwise, if the sequence axis divides -> **sequence routing**: whole
  pages owned block-cyclically by ``page_idx % shards``;
* neither -> the config is refused, as the mesh rules would replicate the
  cache (which would make "sharded" a lie).

Each shard models its own memory controller and lane engine (the aggregate
report sums silicon and takes the worst shard's latency), and every queued
job is cancellation-scoped ``(shard, rid)``, so retiring a request's work
on shard 0 can never cancel a same-rid job queued on shard 1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.controller import MemoryController
from repro_torch.serving.backends.base import KVBackend, MemTier
from repro_torch.serving.kv_cache import PageKey


def kv_cache_owner(shape: tuple, shards: int) -> str:
    """Which axis of a (L, B, S, Hkv, hd) decode cache ``shards``
    model-parallel workers split (the reference's ``_kv_spec`` on a (1,
    shards) ('data', 'model') mesh, as ``cache_pspecs`` applies it to the
    k, v and ring ``pos`` leaves): "head" when the shard count divides Hkv
    (comm-free decode), else "seq" when it divides S (context-parallel
    decode), else "replicate"."""
    s, hkv = shape[-3], shape[-2]
    if hkv % shards == 0:
        return "head"
    if s % shards == 0:
        return "seq"
    return "replicate"


class ShardedBackend(KVBackend):
    name = "sharded"

    # ------------------------------------------------------------ validation
    @classmethod
    def check_model(cls, mcfg, cfg) -> None:
        if mcfg.decode_staging > 0:
            raise ValueError(
                f"decode_staging={mcfg.decode_staging} with "
                f"backend='sharded' is not supported: the staging ring is "
                f"not split along the page route, so per-shard byte "
                f"accounting would be wrong"
            )
        super().check_model(mcfg, cfg)

    def __init__(self, model, cfg, device, controller: MemoryController | None = None,
                 stats=None, telemetry=None):
        self.shards = max(1, int(cfg.shards))
        super().__init__(model, cfg, device, controller=controller, stats=stats,
                         telemetry=telemetry)
        self._route, self._cols = self._plan_route()

    # ----------------------------------------------------------------- tiers
    def _build_tiers(self, controller) -> List[MemTier]:
        if controller is not None and self.shards > 1:
            raise ValueError(
                "ShardedBackend models one MemoryController per shard; an "
                "externally supplied controller only makes sense with "
                "shards=1 (use backend='paged' to capture a single trace)"
            )
        budget = self.cfg.max_stored_bytes
        per = None if budget is None else max(1, budget // self.shards)
        return [
            MemTier(self.cfg, controller if s == 0 else None, per, index=s,
                    telemetry=self.telemetry)
            for s in range(self.shards)
        ]

    def _plan_route(self):
        """The owner rule on the decode cache's shape -> the page route (a
        head route's per-shard channel columns)."""
        m = self.mcfg
        ring = 0 < m.attn_window < self.cfg.max_ctx
        shape = (m.n_layers, self.cfg.max_batch,
                 m.attn_window if ring else self.cfg.max_ctx, m.n_kv_heads, m.head_dim)
        owner = kv_cache_owner(shape, self.shards)
        if owner == "head":
            per_shard = m.n_kv_heads // self.shards * m.head_dim
            return "head", [slice(s * per_shard, (s + 1) * per_shard)
                            for s in range(self.shards)]
        if owner == "seq":
            return "seq", None
        raise ValueError(
            f"shards={self.shards} divides neither n_kv_heads "
            f"({m.n_kv_heads}) nor max_ctx ({shape[2]}) — the mesh "
            f"rules would replicate the cache, so there is nothing to shard"
        )

    # --------------------------------------------------------------- routing
    def _page_targets(self, key: PageKey) -> List[Tuple[MemTier, Optional[slice]]]:
        if self._route == "head":
            return [(tier, self._cols[tier.index]) for tier in self.tiers]
        return [(self.tiers[key.page_idx % self.shards], None)]

    def _seq_key(self, tier: MemTier, rid: int):
        # shard-scoped cancellation: retire-time cancel_seq((s, rid)) on one
        # shard's queue can never match another shard's (s', rid) jobs
        return (tier.index, rid)

    # ------------------------------------------------------------- reporting
    def report(self) -> dict:
        s = super().report()
        s["shard_route"] = self._route
        shards = []
        for tier in self.tiers:
            er = tier.engine.report()
            fp = tier.store.footprint()
            w_log, w_phys = tier.controller.stats.kind_bytes("kv_write")
            shards.append({
                "shard": tier.index,
                "kv_logical_bytes": w_log,
                "kv_stored_bytes": w_phys,
                "kv_fetch_physical": tier.controller.stats.kind_bytes("kv_read")[1],
                "kv_evictions": fp["evictions"],
                "shared_stored_bytes": fp["shared_stored_bytes"],
                "engine_utilization": er["utilization"],
                "engine_modeled_latency_ns": er["modeled_latency_ns"],
            })
        s["shards"] = shards
        return s
