"""Per-slot sliding-window ring tier (port of the reference's
``serving/backends/ring.py``): Mixtral-family configs join continuous
batching.

The device cache is the model's ring — sequence axis = ``attn_window``,
plus a ``pos`` plane of absolute positions — made per-slot addressable by
the per-row ring branches of ``models/attention`` (a (B,) ``len`` decode
append, the masked chunk append of bucketed prefill).  The compressed tier
follows the window:

* only pages wholly inside the window are ever stored (a prompt longer
  than the window skips its dead prefix: those device rows are already
  overwritten and masked);
* a stored page whose last token slides out of the window is retired
  (``store.drop_page``: dead, not cold — no eviction counters, no bus
  bytes), so capacity tracks the O(window) live set, not the context;
* a page partly outside the window is charged at full cost until it dies
  (the fetch really moves those bytes though the mask discards some
  rows), but it can no longer be re-activated after an eviction — some of
  its device rows are gone — so an evicted boundary page counts as a
  fetch miss instead of re-compressing garbage.

Prefill chunks are capped at the window (``max_prefill_bucket``) so a
chunk's ring slots never collide; only bucketed prefill is accepted (a
left-padded full-length prefill cache cannot be copied into a window-sized
ring row for row).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.backends.base import KVBackend, SlotState
from repro_torch.serving.kv_cache import PAGE_TOKENS


class RingBackend(KVBackend):
    name = "ring"

    # ------------------------------------------------------------ validation
    @classmethod
    def check_model(cls, mcfg, cfg) -> None:
        if mcfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"continuous batching supports dense-cache families, got "
                f"{mcfg.family!r}"
            )
        if not (0 < mcfg.attn_window < cfg.max_ctx):
            raise ValueError(
                f"backend='ring' serves sliding-window caches; "
                f"attn_window={mcfg.attn_window} with max_ctx={cfg.max_ctx} "
                f"is full attention — use backend='paged'"
            )
        if mcfg.attn_window < PAGE_TOKENS:
            raise ValueError(
                f"attn_window ({mcfg.attn_window}) must hold at least one "
                f"prefill bucket ({PAGE_TOKENS} tokens)"
            )
        if mcfg.decode_staging > 0:
            raise ValueError(
                f"decode_staging={mcfg.decode_staging} with backend='ring' "
                f"is not supported: a sliding-window ring cache already "
                f"appends in place, so there is no staging window to fold"
            )
        if cfg.prefill_mode != "bucketed":
            raise ValueError(
                "backend='ring' requires prefill_mode='bucketed' (a padded "
                "full-length prefill cache cannot adopt into a window ring)"
            )
        if cfg.device_kv == "bitplane" and mcfg.attn_window % PAGE_TOKENS:
            raise ValueError(
                f"bit-plane ring caches need attn_window to be a multiple "
                f"of PAGE_TOKENS ({PAGE_TOKENS}) so device pages fold "
                f"cleanly, got {mcfg.attn_window}"
            )
        cls.check_device_kv(mcfg, cfg)

    @property
    def window(self) -> int:
        return self.mcfg.attn_window

    # ---------------------------------------------------------- device cache
    def bind_slot(self, slot_id: int, rid: int) -> None:
        super().bind_slot(slot_id, rid)
        # a reused slot still holds its previous occupant's ring entries, and
        # the position mask (0 <= pos < kv_valid) cannot tell a stale
        # in-range position from a real one (a dense cache overwrites old
        # rows in order before they could be attended; a ring does not):
        # mark every slot position unfilled, in place
        if self._cache is not None:
            self._cache["pos"][:, slot_id] = -1

    def max_prefill_bucket(self) -> int:
        # a chunk writes C distinct ring slots; C <= window keeps them
        # collision-free and the concat-attend chunk path correct
        return min(self.cfg.max_ctx, self.window)

    def _device_rows(self, t0: int, t1: int):
        r0 = t0 % self.window
        if r0 + (t1 - t0) <= self.window:
            return slice(r0, r0 + (t1 - t0))
        return np.arange(t0, t1) % self.window

    # ------------------------------------------------------- window tracking
    def _first_storable_token(self, end: int) -> int:
        # first token of the first wholly-live page: earlier device rows are
        # already overwritten by the sliding window
        dead = max(0, end - self.window)
        return -(-dead // PAGE_TOKENS) * PAGE_TOKENS

    def _expire_dead_pages(self, st: SlotState, ln: int) -> None:
        dead_end = max(0, ln - self.window) // PAGE_TOKENS
        for p in range(st.live_from_page, dead_end):
            bound = st.bound_from_page <= p < st.shared_pages
            for li in range(self.stored_layers()):
                for stream in ("k", "v"):
                    key = self._slot_key(st, li, p, stream)
                    for tier, _cols in self._page_targets(key):
                        if bound:
                            # this holder's window slid past the shared page:
                            # its binding ends here (sharing lasts only while
                            # the prefix is inside every holder's window)
                            tier.store.release_page(key)
                        # refused (the page survives) while another holder
                        # still has it bound
                        tier.store.drop_page(key)
            # its device rows now belong to a newer page: drop the ladder
            # entry so the plane map never applies a dead page's precision
            st.page_planes.pop(p, None)
        st.live_from_page = max(st.live_from_page, dead_end)
        if st.shared_pages and dead_end > st.bound_from_page:
            st.bound_from_page = min(dead_end, st.shared_pages)

    def _can_reactivate(self, st: SlotState, page_idx: int, ln: int) -> bool:
        # every device row of the page must still be inside the window
        return page_idx * PAGE_TOKENS >= max(0, ln - self.window)

    # --------------------------------------------------------- prefix sharing
    def _prefix_adopt_lo(self, m: int) -> int:
        # the ring holds only the trailing `window` rows; adoption rebuilds
        # exactly those (registered prefixes fit the window, see
        # _prefix_register_ok, so in practice lo == 0)
        return max(0, m - self.window)

    def _prefix_register_ok(self, st: SlotState, end: int) -> bool:
        # a prompt longer than the window has already overwritten its own
        # head rows: there is nothing whole left to snapshot, and a follower
        # could never share pages outside its live window anyway
        return end <= self.window

    def _adopt_prefix_rows(self, slot_id, entry, lo: int, m: int) -> None:
        super()._adopt_prefix_rows(slot_id, entry, lo, m)
        # ring rows are position-masked, not index-ordered: publish the
        # adopted rows' absolute positions, or the mask treats them as
        # unfilled (bind_slot reset them to -1)
        pos = self._cache["pos"]
        for row, off, n in self._row_runs(lo, m):
            pos[:, slot_id, row:row + n] = torch.arange(
                lo + off, lo + off + n, dtype=torch.int32, device=pos.device)

    # ------------------------------------------------------ device plane map
    def _device_page(self, page_idx: int) -> int:
        return page_idx % (self.window // PAGE_TOKENS)

    def _push_device_planes(self, slot_id: int, st: SlotState) -> None:
        self._sync_ring_planes(slot_id, st, st.stored_tokens)

    def _account_step_fetch(self, slot_id: int, ln: int) -> None:
        # re-sync every decode token: the growing ring head reclaims a dying
        # page's device rows token by token, and those rows must fall back
        # to full precision the moment they stop being that page's
        if self.device_kv == "bitplane":
            self._sync_ring_planes(slot_id, self._slots[slot_id], ln)
        super()._account_step_fetch(slot_id, ln)

    def _sync_ring_planes(self, slot_id: int, st: SlotState, ln: int) -> None:
        """Ring plane map: only pages whose device rows are still wholly
        their own keep their rung; a boundary page sharing rows with the
        ring head — and the head itself — read at full precision (the
        newest tokens are never truncated by a stale assignment)."""
        if self.device_kv != "bitplane" or self._cache is None:
            return
        bits = self.tiers[0].store.spec.bits
        wp = self.window // PAGE_TOKENS
        row = np.full(wp, bits, np.int32)
        # the NEXT append lands at slot ln % w: any page whose device rows
        # that slot (or an earlier reclaimed one) belongs to must already
        # read full precision — a strictly-greater cutoff, so an exactly
        # page-aligned ln retires page (ln - w) / 16 one step early, never
        # late
        first_intact = ((ln - self.window) // PAGE_TOKENS + 1
                        if ln >= self.window else 0)
        for p, keep in st.page_planes.items():
            if p >= first_intact:
                row[p % wp] = keep
        self._set_device_row(slot_id, st, row)
