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
