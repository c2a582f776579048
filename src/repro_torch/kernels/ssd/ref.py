"""Plain PyTorch version of the SSD kernel: the twin of the reference's
``models/ssm.py::_ssd_scan_body`` (chunked state-space duality,
arXiv:2405.21060), all in float32.

b and c come per group, (B, L, G, N) with G dividing H; they are expanded
to heads (head h takes group h // (H / G), the model's mapping) before any
product, so with G = H it is the reference's per-head function exactly.
It materialises the (B, nc, Q, Q, H) decay-masked scores that the kernel
never holds.  The CPU path and the parity tests run it; on the card it is
the kernel's reference.

:func:`ssd_bwd_ref` is the backward of :func:`ssd_chunked` in closed form:
the function that ``csrc/ssd_bwd.cu`` computes, and the plain backward of
``ops.SSDScan`` on the CPU.
"""

from __future__ import annotations

import torch


def groups_to_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, ..., G, N) -> (B, ..., H, N) by contiguous block mapping: head h
    takes group h // (H / G)."""
    return torch.repeat_interleave(t, h // t.shape[-2], dim=-2)


def ssd_chunked(xdt, da, b, c, h0, q: int, workspaces: bool = False):
    """The chunked scan over L a multiple of ``q``.

    xdt (B, L, H, P); da (B, L, H) per-position dt·A (negative); b/c
    (B, L, G, N) with G dividing H; h0 (B, H, N, P); all float32.  Returns
    (y (B, L, H, P), h_final (B, H, N, P)) float32; with ``workspaces``
    also the kernel's two workspaces in its layouts, which the backward
    reads: cum (B, H, L), each chunk's inclusive cumsum of da, and states
    (B, L / q, H, N, P), the state before each chunk."""
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
    if workspaces:
        return y, state, cum.permute(0, 3, 1, 2).reshape(bsz, h, l), h_befores
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


def ssd_bwd_ref(xdt, b, c, dy, dh_final, cum, states, q: int):
    """The backward of :func:`ssd_chunked` in closed form, float32.

    xdt (B, L, H, P), b/c (B, L, G, N) as the forward took them (L a
    multiple of ``q``); dy (B, L, H, P) and dh_final (B, H, N, P) or None
    (zero) the gradients of y and h_final; cum (B, H, L) and states (B,
    L / q, H, N, P) the forward's workspaces (``ssd_chunked(...,
    workspaces=True)``; states[:, 0] is h0, so h0 itself is not read, nor
    da, whose cumsum cum holds).  Returns (dxdt (B, L, H, P), dda (B, L,
    H), db, dc (B, L, G, N) summed over the heads of each group, dh0 (B,
    H, N, P)).

    Within a chunk, with L_ij = exp(cum_i - cum_j) (i >= j), w_j =
    exp(cum_Q - cum_j), h_c the state before chunk c and G_c = dL/dh_c:
      G_c    = sum_i exp(cum_i) c_i (x) dy_i + exp(cum_Q) G_{c+1},
               G_nc = dh_final, dh0 = G_0
      dxdt_j = sum_{i>=j} (c_i.b_j) L_ij dy_i + w_j b_j^T G_{c+1}
      db_j   = sum_{i>=j} L_ij (dy_i.xdt_j) c_i + w_j G_{c+1} xdt_j
      dc_i   = sum_{j<=i} L_ij (dy_i.xdt_j) b_j + exp(cum_i) h_c dy_i
    and dda is the in-chunk reverse cumsum of dcum: the row sums less the
    column sums of M = L o (c.b) o (dy.xdt) (its diagonal, in both,
    cancels and is left out of both), plus c_i . (the inter part of
    dc_i), less xdt_j . (the w part of dxdt_j), plus, at the chunk's last
    position, exp(cum_Q) <G_{c+1}, h_c> + sum_j xdt_j . (the w part of
    dxdt_j).  The masked half's exponent cum_i - cum_j (i < j, positive)
    goes to -inf before exp, as in the forward."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    nc = l // q
    b_h, c_h = groups_to_heads(b, h), groups_to_heads(c, h)

    def r(t):
        return t.reshape(bsz, nc, q, *t.shape[2:])

    x_c, b_c, c_c, dy_c = r(xdt), r(b_h), r(c_h), r(dy)
    cum_c = cum.reshape(bsz, h, nc, q).permute(0, 2, 3, 1)  # (B, nc, Q, H)
    cum_last = cum_c[:, :, -1:, :]
    seg = cum_c[:, :, :, None, :] - cum_c[:, :, None, :, :]  # (B, nc, Q, Q, H) [i, j]
    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    decay = seg.masked_fill(~causal[None, None, :, :, None], float("-inf")).exp()
    del seg
    sl = torch.einsum("bcihn,bcjhn->bcijh", c_c, b_c) * decay  # (c_i.b_j) L_ij
    dp = torch.einsum("bcihp,bcjhp->bcijh", dy_c, x_c)  # dy_i.xdt_j
    e = dp * decay
    # M off its diagonal (the diagonal's row and column terms cancel)
    m = sl * dp * (~torch.eye(q, dtype=torch.bool, device=xdt.device))[None, None, :, :, None]
    del decay, dp

    # the reverse pass over chunks: gn[:, c] = G_{c+1}
    ecum = torch.exp(cum_c)
    t_chunk = torch.einsum("bcihn,bcih,bcihp->bchnp", c_c, ecum, dy_c)
    chunk_decay = torch.exp(cum_last[:, :, 0, :])  # (B, nc, H)
    grad = torch.zeros_like(states[:, 0]) if dh_final is None else dh_final
    after = []
    for ci in reversed(range(nc)):
        after.append(grad)
        grad = grad * chunk_decay[:, ci, :, None, None] + t_chunk[:, ci]
    gn = torch.stack(after[::-1], dim=1)  # (B, nc, H, N, P)

    w = torch.exp(cum_last - cum_c)  # (B, nc, Q, H)
    dx_state = w[..., None] * torch.einsum("bcjhn,bchnp->bcjhp", b_c, gn)
    dx = torch.einsum("bcijh,bcihp->bcjhp", sl, dy_c) + dx_state
    db = (torch.einsum("bcijh,bcihn->bcjhn", e, c_c)
          + w[..., None] * torch.einsum("bcjhp,bchnp->bcjhn", x_c, gn))
    dc_inter = ecum[..., None] * torch.einsum("bcihp,bchnp->bcihn", dy_c, states)
    dc = torch.einsum("bcijh,bcjhn->bcihn", e, b_c) + dc_inter

    u = (x_c * dx_state).sum(-1)  # (B, nc, Q, H)
    dcum = m.sum(dim=3) - m.sum(dim=2) + (c_c * dc_inter).sum(-1) - u
    dcum[:, :, -1, :] += chunk_decay * (gn * states).sum((-2, -1)) + u.sum(dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))

    def heads_to_groups(t):
        return t.reshape(bsz, l, g, h // g, n).sum(dim=3)

    return (dx.reshape(bsz, l, h, p), dda.reshape(bsz, l, h),
            heads_to_groups(db.reshape(bsz, l, h, n)),
            heads_to_groups(dc.reshape(bsz, l, h, n)), grad)
