"""The SSD scan (port of the reference's ``kernels/ssd/ops.py``): the
zero-state default and the chunk padding, then the dispatch.

Dispatch: CPU tensors take the plain PyTorch version in :mod:`.ref`; CUDA
tensors launch the hand-written kernel (:mod:`.kernel`) or raise.  There
is no other route.

Where autograd will differentiate the call (grad mode on, an input
requiring grad), it runs through :class:`SSDScan`: the forward also keeps
the kernel's two workspaces (each chunk's cumsum and the state before each
chunk), and the backward is the hand-written backward kernel
(``csrc/ssd_bwd.cu``) on CUDA, the plain closed-form backward
(:func:`.ref.ssd_bwd_ref`) on the CPU.  Other calls (serving) launch the
forward alone, as before.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import aligned
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref as R


class SSDScan(torch.autograd.Function):
    """The chunked scan over inputs already padded to a multiple of the
    chunk ``q`` (float32): (y, h_final).  The forward saves xdt, b, c, the
    workspaces cum and states, and h_final; the backward reads no da and no
    h0 (states[:, 0] is h0).  dh0 is computed only where h0 requires a
    gradient; a gradient of h_final that autograd leaves out is zero."""

    @staticmethod
    def forward(ctx, xdt, da, b, c, h0, q):
        if xdt.device.type == "cpu":
            y, h_final, cum, states = R.ssd_chunked(xdt, da, b, c, h0, q, workspaces=True)
        else:
            y, h_final, cum, states = K.ssd(xdt, da, b, c, h0, chunk=q, workspaces=True)
        ctx.save_for_backward(xdt, b, c, cum, states, h_final)
        ctx.q = q
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        xdt, b, c, cum, states, h_final = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        if xdt.device.type == "cpu":
            dx, dda, db, dc, dh0 = R.ssd_bwd_ref(xdt, b, c, dy, dh_final, cum, states, ctx.q)
        else:
            dh_final = None if dh_final is None else aligned(dh_final)
            dx, dda, db, dc, dh0 = K.ssd_bwd(xdt, b, c, aligned(dy), cum, states, h_final,
                                             dh_final, chunk=ctx.q)
        return dx, dda, db, dc, dh0 if ctx.needs_input_grad[4] else None, None


def ssd(xdt, da, b, c, h0=None, chunk: int = 256):
    """The scan behind ``models.ssm.ssd_scan``: the reference's contract
    with b and c per group.

    xdt (B, L, H, P) inputs pre-scaled by dt; da (B, L, H) per-position
    dt·A (negative); b/c (B, L, G, N) with G dividing H, head h reading
    group h // (H / G) (the model's groups-to-heads mapping; G = H is the
    reference's per-head b_h/c_h); h0 (B, H, N, P) or None for a zero
    state.  Any L: it is padded to a multiple of ``min(chunk, L)`` with
    zero inputs and da = 0.  Returns (y (B, L, H, P), h_final (B, H, N,
    P)), float32.  Differentiable (see :class:`SSDScan`)."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    if g <= 0 or h % g:
        raise ValueError(f"{g} groups of b and c do not divide {h} heads")
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on cpu or cuda tensors, got {xdt.device}")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xdt, da, b, c, h0))
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xdt.device)
    (xdt, da, b, c), q = R.pad_to_chunks(xdt, da, b, c, chunk)
    h0 = h0.float()
    if xdt.device.type == "cuda":
        xdt, da, b, c, h0 = (aligned(t) for t in (xdt, da, b, c, h0))
    if grad:
        y, h_final = SSDScan.apply(xdt, da, b, c, h0, q)
    elif xdt.device.type == "cpu":
        y, h_final = R.ssd_chunked(xdt, da, b, c, h0, q)
    else:
        y, h_final = K.ssd(xdt, da, b, c, h0, chunk=q)
    return y[:, :l], h_final
