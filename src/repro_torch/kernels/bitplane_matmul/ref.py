"""Plain PyTorch versions for the matrix product with bit-plane weights
(the reference's ``kernels/bitplane_matmul/ref.py``).

Weight-plane layout: planes (bits, K, N/8) uint8 — bit ``i`` (0 = MSB) of
W[k, n] lives at planes[i, k, n/8] bit (7 - n%8) (packbits convention
along the N axis), i.e. the flat bit-plane pack of the row-major (K, N)
matrix.  ``ops.py`` runs these for CPU tensors; the chip smoke script
holds the kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitplane.ref import pack_ref, unpack_ref


def pack_weights_ref(w_bits: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """(K, N) raw 16-bit patterns (``int16``) -> (bits, K, N/8) uint8."""
    k, n = w_bits.shape
    if n % 8 != 0:
        raise ValueError(f"N must be a multiple of 8, got {n}")
    return pack_ref(w_bits.reshape(-1), bits).reshape(bits, k, n // 8)


def reconstruct_ref(planes: torch.Tensor, keep: int, bits: int = 16) -> torch.Tensor:
    """planes -> (K, N) bf16 with the low (bits - keep) planes zeroed."""
    _, k, n8 = planes.shape
    u = unpack_ref(planes.reshape(planes.shape[0], -1), bits, keep, torch.int16)
    return u.view(torch.bfloat16).reshape(k, n8 * 8)


def bitplane_matmul_ref(x: torch.Tensor, planes: torch.Tensor, keep: int,
                        bits: int = 16) -> torch.Tensor:
    """x (M, K) bf16 × plane-stored W -> (M, N) float32 (bf16 products are
    exact in float32; the sums are float32)."""
    return x.float() @ reconstruct_ref(planes, keep, bits).float()
