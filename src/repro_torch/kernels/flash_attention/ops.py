"""Flash attention (the reference's ``models/attention.py::flash_attention``
with its custom VJP): argument normalisation, then the dispatch.

Dispatch: CPU tensors take the plain PyTorch version in :mod:`.ref`; CUDA
tensors launch the hand-written kernel (:mod:`.kernel`) or raise.  There
is no other route.  A kernel call whose keys the launch plan splits (a
short prefill chunk over a long cache) launches the attention kernel and
the kernel that merges the splits' float32 partials from a workspace the
wrapper allocates; it counts as one launch.

Where autograd will differentiate the call (grad mode on, q, k or v
requiring grad), it runs through :class:`FlashAttention`: the forward also
returns each row's log-sum-exp, and the backward is the hand-written
backward kernel on CUDA, the plain backward (:func:`.ref.flash_attention_bwd_ref`,
the reference's ``_flash_bwd``) on the CPU, so that the CPU's gradients
round where the reference's do rather than where autograd of the plain
forward would.  Other calls (serving) launch the forward alone, as before.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import aligned
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward saves
    (q, k, v, out, lse), the backward recomputes the scores from them.  A
    backward through keys at their own positions (``kv_pos``, a ring
    cache's chunk) raises: the reference's backward rebuilds positions from
    indices, and nothing trains through a ring."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_valid, causal, window, valid, kv_pos):
        if q.device.type == "cpu":
            out, lse = R.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                             causal=causal, window=window, kv_pos=kv_pos,
                                             return_lse=True)
        else:
            out, lse = K.flash_attention(q, k, v, q_pos, kv_valid, causal=causal,
                                         window=window, valid=valid, kv_pos=kv_pos, lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_valid)
        ctx.causal, ctx.window, ctx.ring = causal, window, kv_pos is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.ring:
            raise ValueError("flash attention has no backward through key positions "
                             "(kv_pos): the reference's rebuilds them from indices")
        q, k, v, out, lse, q_pos, kv_valid = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = R.flash_attention_bwd_ref(q, k, v, out, dout, lse, q_pos=q_pos,
                                                   kv_valid=kv_valid, causal=ctx.causal,
                                                   window=ctx.window)
        else:
            dq, dk, dv = K.flash_attention_bwd(q, k, v, out, aligned(dout), lse, q_pos,
                                               kv_valid, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                    window: int = 0, kv_pos=None):
    """q (B, Sq, Hp, hd); k/v (B, Skv, Hkv, hd), q head ``h`` reading kv
    head ``h // (Hp / Hkv)``; q_pos (B, Sq) absolute query positions;
    kv_valid an int or (B,): keys at positions >= it are masked; kv_pos
    (B, Skv), optional: the keys' absolute positions (a ring cache; -1 =
    unfilled), else their indices.  See :func:`.ref.flash_attention_ref`
    for the masks and rounding points.  Returns (B, Sq, Hp, hd) in
    q.dtype.  Differentiable (see :class:`FlashAttention`)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.device.type == "cpu" and not grad:
        return R.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                     causal=causal, window=window, kv_pos=kv_pos)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    b = q.shape[0]
    # an int kv_valid (a prefill chunk's end in its slot) is known here: the
    # launch plan splits only the keys below it.  Keys at their own
    # positions are in no index order, so the plan then covers them all.
    valid = kv_valid if isinstance(kv_valid, int) and kv_pos is None else None
    q_pos = q_pos.to(device=q.device, dtype=torch.int32).expand(b, q.shape[1])
    kv_valid = R.kv_valid_rows(kv_valid, b, q.device)
    if kv_pos is not None:
        kv_pos = kv_pos.to(device=q.device, dtype=torch.int32).expand(b, k.shape[1])
    if q.device.type == "cuda":
        q, k, v, q_pos, kv_valid = (aligned(t) for t in (q, k, v, q_pos, kv_valid))
        kv_pos = None if kv_pos is None else aligned(kv_pos)
    if grad:
        return FlashAttention.apply(q, k, v, q_pos, kv_valid, bool(causal), int(window),
                                    valid, kv_pos)
    return K.flash_attention(q, k, v, q_pos, kv_valid, causal=causal, window=window,
                             valid=valid, kv_pos=kv_pos)
