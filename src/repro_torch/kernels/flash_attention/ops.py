"""Flash-attention prefill (the forward of the reference's
``models/attention.py::flash_attention``): argument normalisation, then the
dispatch.

Dispatch: CPU tensors take the plain PyTorch version in :mod:`.ref`; CUDA
tensors launch the hand-written kernel (:mod:`.kernel`) or raise.  There
is no other route.  A kernel call whose keys the launch plan splits (a
short prefill chunk over a long cache) launches the attention kernel and
the kernel that merges the splits' float32 partials from a workspace the
wrapper allocates; it counts as one launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import aligned
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


def flash_attention(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                    window: int = 0):
    """q (B, Sq, Hp, hd); k/v (B, Skv, Hkv, hd), q head ``h`` reading kv
    head ``h // (Hp / Hkv)``; q_pos (B, Sq) absolute query positions;
    kv_valid an int or (B,): keys at positions >= it are masked.  See
    :func:`.ref.flash_attention_ref` for the masks and rounding points.
    Returns (B, Sq, Hp, hd) in q.dtype."""
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                     causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    b = q.shape[0]
    # an int kv_valid (a prefill chunk's end in its slot) is known here: the
    # launch plan splits only the keys below it
    valid = kv_valid if isinstance(kv_valid, int) else None
    q_pos = q_pos.to(device=q.device, dtype=torch.int32).expand(b, q.shape[1])
    kv_valid = R.kv_valid_rows(kv_valid, b, q.device)
    return K.flash_attention(*(aligned(t) for t in (q, k, v, q_pos, kv_valid)),
                             causal=causal, window=window, valid=valid)
