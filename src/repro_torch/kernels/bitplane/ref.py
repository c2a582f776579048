"""Plain PyTorch versions of bit-plane pack and unpack (the reference's
``kernels/bitplane/ref.py``), on raw bits in the integer containers of
:mod:`.kernel`.

Semantics pinned to :mod:`repro_torch.core.bitplane` (``disaggregate_np``
/ ``reaggregate_np``): plane 0 = MSB; bytes pack MSB-first along the value
axis (NumPy ``packbits`` convention).  ``ops.py`` runs them for CPU
tensors; the chip smoke script holds each kernel against them on the card.
"""

from __future__ import annotations

import torch

_BYTE_W = tuple(1 << (7 - k) for k in range(8))


def pack_ref(u: torch.Tensor, bits: int) -> torch.Tensor:
    """(m,) raw bits -> (bits, m/8) uint8 planes, MSB-first."""
    m = u.numel()
    if m % 8 != 0:
        raise ValueError(f"bit-planes pack octets of values; m={m} is not a multiple of 8")
    # a sign-extended container is harmless: only bits below `bits` are read
    wide = u.reshape(m).to(torch.int64)
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int64, device=u.device)
    planes_bits = (wide[None, :] >> shifts[:, None]) & 1
    grouped = planes_bits.reshape(bits, m // 8, 8)
    weights = torch.tensor(_BYTE_W, dtype=torch.int64, device=u.device)
    return (grouped * weights).sum(-1).to(torch.uint8)


def unpack_ref(planes: torch.Tensor, bits: int, keep: int,
               dtype: torch.dtype) -> torch.Tensor:
    """planes (n >= keep, m/8) uint8 -> (m,) raw bits in ``dtype`` from the
    top ``keep`` planes; the rest read as zero (the partial-plane fetch of
    Fig. 5)."""
    m8 = planes.shape[1]
    shifts8 = torch.arange(7, -1, -1, dtype=torch.int64, device=planes.device)
    fetched = planes[:keep].to(torch.int64)
    bits_mat = (fetched[:, :, None] >> shifts8) & 1  # (keep, m8, 8)
    weights = torch.tensor([1 << (bits - 1 - i) for i in range(keep)],
                           dtype=torch.int64, device=planes.device)
    u = (bits_mat.reshape(keep, m8 * 8) * weights[:, None]).sum(0)
    # two's-complement narrowing: the container keeps the low bits exactly
    width = torch.empty((), dtype=dtype).element_size()
    u = u & ((1 << 8 * width) - 1)
    if width < 8 and dtype != torch.uint8:
        u = torch.where(u >= 1 << (8 * width - 1), u - (1 << 8 * width), u)
    return u.to(dtype)


def pack_kv_ref(kv: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """(..., hd) bf16 -> (bits, ..., hd//8) uint8: the flat bit-plane pack
    of the row-major values, each plane reshaped like ``kv``."""
    u = kv.to(torch.bfloat16).contiguous().view(torch.int16).reshape(-1)
    return pack_ref(u, bits).reshape((bits,) + kv.shape[:-1] + (kv.shape[-1] // 8,))


def unpack_kv_ref(planes: torch.Tensor, keep: int, bits: int = 16) -> torch.Tensor:
    """(n >= keep, ..., hd//8) planes -> (..., hd) bf16, low planes zeroed
    (truncation to the top ``keep`` planes; keep 0 reads zero)."""
    m8 = planes[0].numel()
    u = unpack_ref(planes[:keep].reshape(keep, m8), bits, keep, torch.int16)
    return u.view(torch.bfloat16).reshape(planes.shape[1:-1] + (planes.shape[-1] * 8,))


def pack_kv_into_ref(k: torch.Tensor, v: torch.Tensor, k_planes: torch.Tensor,
                     v_planes: torch.Tensor, start) -> None:
    """The plain version of ``kernel.pack_kv_into``: each stream packed by
    itself, then written into its planes IN PLACE, as the attention layer
    wrote them before the two were one launch.  A Python ``start`` writes
    rows [start, start + c) (the reference's ``dynamic_update_slice``); a
    tensor writes row a's one token at clamp(start[a], 0, S - 1) (the
    reference's ``.at[:, rows, slot].set``)."""
    bits = k_planes.shape[0]
    if not torch.is_tensor(start):
        end = int(start) + k.shape[1]
        if not 0 <= int(start) <= end <= k_planes.shape[2]:
            raise ValueError(f"rows [{int(start)}, {end}) outside the cache's "
                             f"{k_planes.shape[2]}")
        k_planes[:, :, int(start):end] = pack_kv_ref(k, bits)
        v_planes[:, :, int(start):end] = pack_kv_ref(v, bits)
        return
    if k.shape[1] != 1:
        raise ValueError(f"a start per row takes one token a row, got {k.shape[1]}")
    rows = torch.arange(k_planes.shape[1], device=k_planes.device)
    slot = torch.clamp(start, 0, k_planes.shape[2] - 1).long()
    k_planes[:, rows, slot] = pack_kv_ref(k, bits)[:, :, 0]
    v_planes[:, rows, slot] = pack_kv_ref(v, bits)[:, :, 0]


def unpack_kv_pair_ref(k_planes: torch.Tensor, v_planes: torch.Tensor, keep: int,
                       bits: int = 16) -> torch.Tensor:
    """The plain version of ``kernel.unpack_kv_pair``: (2, ..., hd) bf16,
    each stream unpacked by itself from planes [0, keep)."""
    return torch.stack([unpack_kv_ref(p, keep, bits) for p in (k_planes, v_planes)])
