"""Plain PyTorch version of the flash-attention kernel: the twin of the
reference's ``models/attention.py::_flash_attention_body`` (the forward
the reference's dense, hybrid and enc-dec models run; its TPU form is
``kernels/flash_attention/kernel.py``).

It walks the keys in chunks with an online softmax, as the reference's
``lax.scan`` does, and materialises each chunk's (B, Hp, Sq, chunk) float32
scores, which the kernel never holds.  The CPU path and the parity tests
run it; on the card it is the kernel's reference.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def kv_valid_rows(kv_valid, b: int, device) -> torch.Tensor:
    """``kv_valid`` (an int, a 0-d or a (B,) tensor) -> (B,) int32."""
    t = torch.as_tensor(kv_valid, device=device).to(torch.int32)
    return t.expand(b) if t.dim() == 0 else t


def flash_attention_ref(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                        window: int = 0, chunk: int = 512, kv_pos=None):
    """Online-softmax attention over keys at positions ``kv_pos`` (default
    ``arange(Skv)``).

    q (B, Sq, Hp, hd); k/v (B, Skv, Hkv, hd), Hp a multiple of Hkv: q head
    ``h`` reads kv head ``h // (Hp / Hkv)`` (the grouped layout).  q_pos
    (B, Sq) int: the queries' absolute positions.  kv_valid: an int or
    (B,): keys at positions >= it are masked.  ``kv_pos`` (B, Skv) int,
    optional: each key's absolute position (a ring cache's slots, not
    ordered by index); a negative position marks an unfilled slot, masked.
    ``causal`` masks keys after each query's position; ``window`` > 0 also
    masks keys at positions <= q_pos - window.  Scores, the running max and sum are float32, ``p`` is
    rounded to q's dtype before ``p·v``, and the scale is 1/sqrt(hd), as in
    the reference.  Masked scores are the finite NEG_INF, so a row whose
    first chunk holds no visible key carries garbage that the next visible
    key's correction exp(NEG_INF - m) = 0 wipes out.  Returns (B, Sq, Hp,
    hd) in q.dtype."""
    b, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hp % hkv:
        raise ValueError(f"{hp} q heads over {hkv} kv heads")
    chunk = int(min(chunk, skv))
    hm = torch.arange(hp, device=q.device) // (hp // hkv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32, device=q.device)
    kv_valid = kv_valid_rows(kv_valid, b, q.device)
    qp = q_pos.to(q.device)[:, None, :, None]
    qf = q.float()
    m = torch.full((b, hp, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hp, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hp, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kh = k[:, c0:c0 + chunk][:, :, hm].float()  # (B, ck, Hp, hd)
        vh = v[:, c0:c0 + chunk][:, :, hm].float()
        ck = kh.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kh) * scale
        if kv_pos is None:
            kpos = torch.arange(c0, c0 + ck, device=q.device)[None, None, None, :]
            ok = kpos < kv_valid[:, None, None, None]
        else:
            kpos = kv_pos[:, c0:c0 + ck].to(q.device)[:, None, None, :]
            ok = (kpos >= 0) & (kpos < kv_valid[:, None, None, None])
        if causal:
            ok = ok & (kpos <= qp)
        if window > 0:
            ok = ok & (kpos > qp - window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vh)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
