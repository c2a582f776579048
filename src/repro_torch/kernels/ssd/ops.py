"""The SSD scan (port of the reference's ``kernels/ssd/ops.py``): the
zero-state default and the chunk padding, then the dispatch.

Dispatch: CPU tensors take the plain PyTorch version in :mod:`.ref`; CUDA
tensors launch the hand-written kernel (:mod:`.kernel`) or raise.  There
is no other route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import aligned
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref as R


def ssd(xdt, da, b, c, h0=None, chunk: int = 256):
    """The scan behind ``models.ssm.ssd_scan``: the reference's contract
    with b and c per group.

    xdt (B, L, H, P) inputs pre-scaled by dt; da (B, L, H) per-position
    dt·A (negative); b/c (B, L, G, N) with G dividing H, head h reading
    group h // (H / G) (the model's groups-to-heads mapping; G = H is the
    reference's per-head b_h/c_h); h0 (B, H, N, P) or None for a zero
    state.  Any L: it is padded to a multiple of ``min(chunk, L)`` with
    zero inputs and da = 0.  Returns (y (B, L, H, P), h_final (B, H, N,
    P)), float32."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    if g <= 0 or h % g:
        raise ValueError(f"{g} groups of b and c do not divide {h} heads")
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xdt.device)
    (xdt, da, b, c), q = R.pad_to_chunks(xdt, da, b, c, chunk)
    h0 = h0.float()
    if xdt.device.type == "cpu":
        y, h_final = R.ssd_chunked(xdt, da, b, c, h0, q)
    elif xdt.device.type == "cuda":
        y, h_final = K.ssd(*(aligned(t) for t in (xdt, da, b, c, h0)), chunk=q)
    else:
        raise ValueError(f"ssd runs on cpu or cuda tensors, got {xdt.device}")
    return y[:, :l], h_final
