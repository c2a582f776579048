"""Context-dependent dynamic quantization for KV pages (paper §II.C,
Table II): the Quest page scoring and precision ladder of the reference's
``core/quantization.py`` in torch.

Per 16-token page an importance score is computed from the current query
and the page's per-channel min/max key envelope; pages are ranked and
assigned a precision ladder such as "top 5 pages BF16, next 5 FP8, rest
FP4".  The memory consequence is a plane count: how many bit-planes the
controller fetches (Fig. 5).

Two details keep the ranking identical to the reference, and with it
``device_bytes_read``:

* the reference sorts with ``jnp.argsort``, which is stable; torch's
  ``argsort`` is only stable with ``stable=True``;
* ``quest_scores`` runs in bf16 when the keys are bf16.  Eager jnp rounds
  each elementwise product to bf16 and reduces the sum in float32 before
  rounding it back to bf16; :func:`quest_scores` does the same.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def page_minmax(keys: torch.Tensor, page: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-page channel envelope.  keys: (tokens, heads, dim) ->
    (pages, heads, dim) min and max.  tokens % page == 0 (pad upstream)."""
    t, h, d = keys.shape
    pages = keys.reshape(t // page, page, h, d)
    return pages.amin(dim=1), pages.amax(dim=1)


def quest_scores(q: torch.Tensor, kmin: torch.Tensor, kmax: torch.Tensor) -> torch.Tensor:
    """Upper bound on |q.k| per page/head (Quest's criticality estimate).

    q: (heads, dim); kmin/kmax: (pages, heads, dim) -> scores (pages, heads),
    in the inputs' dtype (products rounded to it, the sum taken in float32)."""
    hi = torch.maximum(q[None] * kmin, q[None] * kmax)
    return hi.float().sum(dim=-1).to(hi.dtype)


@dataclasses.dataclass(frozen=True)
class PrecisionLadder:
    """Ordered (count, planes) rungs; the final rung's count may be -1 = rest.

    Paper Table II examples:
      Ladder([(5, 16), (3, 8), (2, 4)])   top-5 BF16, next 3 FP8, next 2 FP4
      Ladder([(5, 16), (5, 8)])           top-5 BF16, next 5 FP8, rest dropped
    ``drop_rest=True`` evicts pages below the ladder (Quest-style top-k);
    otherwise the rest get the last rung's precision.
    """

    rungs: Sequence[tuple[int, int]]
    drop_rest: bool = False

    def planes_by_rank(self, n_pages: int) -> np.ndarray:
        """(pages,) planes-to-fetch of the page at each rank (0 = dropped)."""
        out = np.zeros(n_pages, np.int32)
        r = 0
        for count, planes in self.rungs:
            count = n_pages - r if count < 0 else count
            out[r : r + count] = planes
            r += count
            if r >= n_pages:
                break
        if r < n_pages and not self.drop_rest:
            out[r:] = self.rungs[-1][1]
        return out

    def plane_assignment(self, order: torch.Tensor, n_pages: int) -> torch.Tensor:
        """order: (pages,) page indices sorted by descending score ->
        (pages,) planes-to-fetch per page (0 = dropped)."""
        ranks = torch.argsort(order, stable=True)  # page index -> rank
        by_rank = torch.as_tensor(self.planes_by_rank(n_pages), device=order.device)
        return by_rank[ranks]


def assign_page_precision(
    scores: torch.Tensor, ladder: PrecisionLadder
) -> torch.Tensor:
    """scores: (pages, heads) -> planes (pages, heads) via per-head ranking
    (ties keep page order, as the reference's stable sort does)."""
    n_pages = scores.shape[0]
    order = torch.argsort(-scores, dim=0, stable=True)  # (pages, heads) descending
    ranks = torch.argsort(order, dim=0, stable=True)
    by_rank = torch.as_tensor(ladder.planes_by_rank(n_pages), device=scores.device)
    return by_rank[ranks]
