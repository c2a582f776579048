"""Plain PyTorch versions of bit-plane paged decode attention.

KV-plane layout: planes (bits, B, S, Hkv, hd//8) uint8 — bit i (0 = MSB) of
K[b, s, h, d] at planes[i, b, s, h, d//8] bit (7 - d%8).

``pack_kv_ref`` / ``unpack_kv_ref`` port the reference's jnp oracles as
the flat bit-plane pack and unpack of the row-major values; they live in
``kernels/bitplane/ref.py``, beside the KV entry points' plain versions.
``paged_attention_fused_ref`` / ``paged_attention_rung_ref`` hold the same
math as the CUDA kernels in ``csrc/paged_attention.cu``: each token's key
and value are rebuilt from planes [0, keep) of its page, scores are taken in
float32 from bf16 inputs, ``p`` is rounded to bf16 before ``p·v``, and the
softmax state stays in float32.  They take one softmax over the whole
sequence where the kernels walk it page by page, so the two agree up to the
order of float32 sums.  ``ops.py`` runs them for CPU tensors; the chip smoke
script holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.bitplane import from_uint
from repro_torch.kernels.bitplane.ref import pack_kv_ref, unpack_kv_ref  # noqa: F401

NEG_INF = -1e30


def _planes_to_uint(planes: torch.Tensor, plane_idx: torch.Tensor, bits: int,
                    live: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of plane bits into raw 16-bit patterns: planes (n, ..., hd8) ->
    (..., hd) int32.  ``live`` (n, ..., 1, 1), broadcast per byte, zeroes
    planes a token does not own."""
    shifts8 = torch.arange(7, -1, -1, dtype=torch.int32, device=planes.device)
    bm = (planes.to(torch.int32)[..., None] >> shifts8) & 1  # (n, ..., hd8, 8)
    if live is not None:
        bm = bm * live
    w = (1 << (bits - 1 - plane_idx.to(torch.int32)))
    w = w.view((-1,) + (1,) * (bm.dim() - 1))
    u = (bm * w).sum(0)
    return u.reshape(u.shape[:-2] + (-1,))


def unpack_kv_keeps_ref(planes: torch.Tensor, tok_keep: torch.Tensor,
                        bits: int = 16) -> torch.Tensor:
    """Per-token plane counts: planes (bits, B, S, Hkv, hd8), tok_keep
    (B, S) -> (B, S, Hkv, hd) bf16 where token (b, s) keeps planes
    [0, tok_keep[b, s])."""
    idx = torch.arange(bits, device=planes.device)
    live = (idx.view(bits, 1, 1) < tok_keep[None].to(torch.int32))
    live = live[..., None, None, None].to(torch.int32)  # (bits, B, S, 1, 1, 1)
    return from_uint(_planes_to_uint(planes, idx, bits, live))


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, rep, hd) bf16, k (B, S, Hkv, hd) bf16, mask (B, S) ->
    masked scaled scores (B, Hkv, rep, S) float32 (f32 sums of bf16
    products, like the kernels' FMA loop)."""
    hd = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    s = torch.einsum("bkrd,bskd->bkrs", q.float(), k.float()) * scale.to(q.device)
    ok = (mask > 0)[:, None, None, :]
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def _partials(s: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    """Unnormalised softmax partials (acc = Σ bf16(p)·v, m, l) over the
    masked scores.  Masked tokens contribute p = 0 — a row with nothing
    valid keeps m = NEG_INF, l = 0, acc = 0, exactly what the kernels
    leave when they skip every page."""
    m = s.amax(dim=-1)
    ok = (mask > 0)[:, None, None, :]
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrs,bskd->bkrd", p.to(torch.bfloat16).float(), v.float())
    return acc, m, l


def paged_attention_fused_ref(q, k_planes, v_planes, page_keeps, mask,
                              bits: int = 16, page_tokens: int = 16):
    """One pass over the whole mixed-precision cache.

    q (B, Hkv, rep, hd) bf16; k/v_planes (bits, B, S, Hkv, hd//8) uint8;
    page_keeps (B, S/page_tokens) int32 — planes [0, keep) of each page are
    read; mask (B, S) int8 (1 = valid).  Returns the normalised output
    (B, Hkv, rep, hd) float32; rows with nothing valid are zero."""
    tok_keep = page_keeps.repeat_interleave(page_tokens, dim=1)
    k = unpack_kv_keeps_ref(k_planes, tok_keep, bits)
    v = unpack_kv_keeps_ref(v_planes, tok_keep, bits)
    mask = mask * (tok_keep > 0).to(mask.dtype)  # keep 0 = page never read
    acc, m, l = _partials(_scores(q, k, mask), v, mask)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.where((m > NEG_INF / 2)[..., None], out, torch.zeros_like(out))


def paged_attention_rung_ref(q, k_planes, v_planes, mask, keep: int,
                             bits: int = 16):
    """One precision rung: every masked-in token at ``keep`` planes.
    Returns unnormalised partials (o (B, Hkv, rep, hd), m, l (B, Hkv, rep))
    float32 for the rung merge in ``ops.py``."""
    k = unpack_kv_ref(k_planes, keep, bits)
    v = unpack_kv_ref(v_planes, keep, bits)
    return _partials(_scores(q, k, mask), v, mask)
