"""Plain PyTorch version of the SSD kernel: the twin of the reference's
``models/ssm.py::_ssd_scan_body`` (chunked state-space duality,
arXiv:2405.21060), all in float32.

b and c come per group, (B, L, G, N) with G dividing H; they are expanded
to heads (head h takes group h // (H / G), the model's mapping) before any
product, so with G = H it is the reference's per-head function exactly.
It materialises the (B, nc, Q, Q, H) decay-masked scores that the kernel
never holds.  The CPU path and the parity tests run it; on the card it is
the kernel's reference.
"""

from __future__ import annotations

import torch


def groups_to_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, ..., G, N) -> (B, ..., H, N) by contiguous block mapping: head h
    takes group h // (H / G)."""
    return torch.repeat_interleave(t, h // t.shape[-2], dim=-2)


def ssd_chunked(xdt, da, b, c, h0, q: int):
    """The chunked scan over L a multiple of ``q``.

    xdt (B, L, H, P); da (B, L, H) per-position dt·A (negative); b/c
    (B, L, G, N) with G dividing H; h0 (B, H, N, P); all float32.  Returns
    (y (B, L, H, P), h_final (B, H, N, P)) float32."""
    bsz, l, h, p = xdt.shape
    if l % q:
        raise ValueError(f"sequence {l} is not a multiple of the ssd chunk {q}")
    nc = l // q
    b_h, c_h = groups_to_heads(b, h), groups_to_heads(c, h)

    def r(t):
        return t.reshape(bsz, nc, q, *t.shape[2:])

    xdt_c, da_c, b_c, c_c = r(xdt), r(da), r(b_h), r(c_h)
    cum = torch.cumsum(da_c, dim=2)  # (B, nc, Q, H) inclusive
    cum_last = cum[:, :, -1:, :]  # (B, nc, 1, H)

    # intra-chunk: seg[i, j] = exp(cum_i - cum_j) for i >= j; the masked
    # half goes to -inf before exp, so its exp(positive) is never taken
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf")).exp()
    att = torch.einsum("bcihn,bcjhn->bcijh", c_c, b_c) * seg
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xdt_c)

    # per-chunk boundary states: S_c = sum_j exp(cum_last - cum_j) B_j (x dt)_j
    w_decay = torch.exp(cum_last - cum)  # (B, nc, Q, H)
    s_chunk = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", b_c, w_decay, xdt_c)
    chunk_decay = torch.exp(cum_last[:, :, 0, :])  # (B, nc, H)

    state = h0
    befores = []
    for c in range(nc):  # the reference's lax.scan over chunks
        befores.append(state)  # the state *before* chunk c
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_befores = torch.stack(befores, dim=1)  # (B, nc, H, N, P)

    # inter-chunk contribution: y_i += exp(cum_i) * C_i . h_before
    y_inter = torch.einsum("bcihn,bcih,bchnp->bcihp", c_c, torch.exp(cum), h_befores)
    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y, state


def pad_to_chunks(xdt, da, b, c, chunk: int):
    """The inputs in float32 with L padded to a multiple of
    ``q = min(chunk, L)`` by zero inputs and da = 0 (decay exp(0) = 1 and
    no input: the carried state is unchanged; copies only where a pad or a
    cast is needed); returns them and q."""
    l = xdt.shape[1]
    q = min(chunk, l)
    pad = (-l) % q
    ts = tuple(t.float() for t in (xdt, da, b, c))
    if pad:
        ts = tuple(torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)
    return ts, q


def ssd_ref(xdt, da, b, c, h0=None, chunk: int = 256):
    """The reference's ``ssd_scan`` contract with b/c per group (G = H:
    per head): any L, zero initial state by default.  Returns (y (B, L, H,
    P), h_final (B, H, N, P)) float32."""
    bsz, l, h, p = xdt.shape
    if h0 is None:
        h0 = torch.zeros((bsz, h, b.shape[-1], p), dtype=torch.float32,
                         device=xdt.device)
    (xdt, da, b, c), q = pad_to_chunks(xdt, da, b, c, chunk)
    y, h_final = ssd_chunked(xdt, da, b, c, h0.float(), q)
    return y[:, :l], h_final
