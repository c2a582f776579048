"""Ladder composition for bit-plane paged decode attention (port of the
reference's ``kernels/paged_attention/ops.py``).

``batched_ladder_paged_attention`` is the serving entry point: one call
covers every slot of a continuous-batching decode step.  Each slot carries
its own valid length and its own per-page plane assignment.  Two kernel
strategies (``kernel=``):

* ``"fused"`` (default) — ONE launch of ``paged_attention_fused``, which
  reads planes [0, keep) of each page itself;
* ``"rung"`` — one launch of ``paged_attention_rung`` per distinct plane
  count in ``keeps`` with a (slot, position) participation mask; the
  unnormalised partials are merged here, in plain torch, as in the
  reference.  Also the fallback when S is not a page multiple.

``pack_kv_planes`` / ``unpack_kv`` move a KV cache between bf16 rows and
its bit-planes through the bit-plane pack and unpack kernels.

Dispatch: a CPU tensor takes the plain PyTorch version in :mod:`.ref`; a
CUDA tensor launches the hand-written kernel (:mod:`.kernel`) or raises.
There is no other route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitplane.ops import pack_raw, unpack_raw
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref as R


def pack_kv_planes(kv: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """(..., hd) bf16 -> (bits, ..., hd//8) uint8 (store path): the flat
    bit-plane pack of the row-major values (the bit-plane pack kernel on a
    CUDA tensor), each plane shaped like ``kv``'s rows."""
    u = kv.to(torch.bfloat16).contiguous().view(torch.int16).reshape(-1)
    return pack_raw(u, bits).reshape((bits,) + kv.shape[:-1] + (kv.shape[-1] // 8,))


def unpack_kv(planes: torch.Tensor, keep: int, bits: int = 16) -> torch.Tensor:
    """(bits, ..., hd//8) planes -> (..., hd) bf16 rebuilt from planes
    [0, keep) (the bit-plane unpack kernel on a CUDA tensor); the low planes
    read as zero."""
    u = unpack_raw(planes[:keep].reshape(keep, -1), bits, keep, torch.int16)
    return u.view(torch.bfloat16).reshape(planes.shape[1:-1] + (planes.shape[-1] * 8,))


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"paged attention runs on cpu or cuda tensors, got {t.device}")


def paged_attention_fused(q, k_planes, v_planes, page_keeps, mask,
                          bits: int = 16, page_tokens: int = 16):
    """Normalised output (B, Hkv, rep, hd) float32 of one pass over the
    mixed-precision cache (see ``ref.paged_attention_fused_ref``)."""
    if _on_cpu(q):
        return R.paged_attention_fused_ref(q, k_planes, v_planes, page_keeps,
                                           mask, bits, page_tokens)
    return K.paged_attention_fused(q, k_planes, v_planes, page_keeps, mask,
                                   bits=bits, page_tokens=page_tokens)


def paged_attention_rung(q, k_planes, v_planes, mask, keep: int, bits: int = 16):
    """Unnormalised partials (o, m, l) of one precision rung."""
    if _on_cpu(q):
        return R.paged_attention_rung_ref(q, k_planes, v_planes, mask, keep, bits)
    return K.paged_attention_rung(q, k_planes, v_planes, mask, keep=keep, bits=bits)


def merge_rung_partials(parts):
    """Merge per-rung (o, m, l) partials into the normalised output
    (reference ``ops.py:173-193``).  A fully masked rung has m = NEG_INF and
    drops out; a row every rung masked comes out zero."""
    o_all, m_all, l_all = parts[0]
    for o_r, m_r, l_r in parts[1:]:
        m_new = torch.maximum(m_all, m_r)
        c_old = torch.exp(m_all - m_new)
        c_new = torch.exp(m_r - m_new)
        o_all = o_all * c_old[..., None] + o_r * c_new[..., None]
        l_all = l_all * c_old + l_r * c_new
        m_all = m_new
    out = o_all / torch.clamp(l_all, min=1e-30)[..., None]
    return torch.where((m_all > R.NEG_INF / 2)[..., None], out,
                       torch.zeros_like(out))


def batched_ladder_paged_attention(
    q: torch.Tensor,
    k_planes: torch.Tensor,
    v_planes: torch.Tensor,
    page_planes: torch.Tensor,
    valid_len: torch.Tensor,
    keeps: tuple,
    *,
    page_tokens: int = 16,
    bits: int = 16,
    q_pos: torch.Tensor | None = None,
    kernel: str = "fused",
) -> torch.Tensor:
    """Multi-slot decode step over a shared bit-plane cache.

    q (B, 1, Hp, hd) bf16; k/v_planes (bits, B, S, Hkv, hd//8) uint8;
    page_planes (B, S/page_tokens) int32 — the plane count the ladder
    assigned to each slot's device page (entries come from ``keeps``);
    valid_len (B,) int32 — per-slot valid cache entries; keeps — the set of
    distinct plane counts the ladder can assign (the rung strategy launches
    once per member); q_pos (B, 1) optional absolute query positions.

    Returns (B, 1, Hp, hd) in q.dtype; a row with no valid entries is zero.
    """
    if kernel not in ("fused", "rung"):
        raise ValueError(f"kernel must be 'fused' or 'rung', got {kernel!r}")
    b, one, hp, hd = q.shape
    if one != 1:
        raise ValueError(f"decode attention takes one query token, got {one}")
    hkv = k_planes.shape[3]
    rep = hp // hkv
    s_total = k_planes.shape[2]
    qg = q.reshape(b, hkv, rep, hd).contiguous()
    valid_len = torch.as_tensor(valid_len, device=q.device)
    if valid_len.dim() == 0:
        valid_len = valid_len.expand(b)
    kpos = torch.arange(s_total, device=q.device, dtype=torch.int32)[None]
    ok = kpos < valid_len[:, None]
    if q_pos is not None:
        ok &= kpos <= q_pos[:, :1]
    if kernel == "fused" and s_total % page_tokens == 0:
        page_keep = page_planes.repeat_interleave(page_tokens, dim=1)
        # a page outside the rung set entirely (keep <= 0) stays unread
        mask = (ok & (page_keep > 0)).to(torch.int8)
        out = paged_attention_fused(
            qg, k_planes, v_planes, page_planes.to(torch.int32).contiguous(),
            mask, bits=bits, page_tokens=page_tokens,
        )
        return out.reshape(b, 1, hp, hd).to(q.dtype)
    page_of = torch.arange(s_total, device=q.device) // page_tokens
    parts = []
    for keep in keeps:
        mask = (ok & (page_planes[:, page_of] == keep)).to(torch.int8)
        parts.append(paged_attention_rung(qg, k_planes, v_planes, mask,
                                          keep=keep, bits=bits))
    out = merge_rung_partials(parts)
    return out.reshape(b, 1, hp, hd).to(q.dtype)
