"""Weight packing and the matrix product with bit-plane weights (port of
the reference's ``kernels/bitplane_matmul/ops.py``).

Dispatch: a CPU tensor takes the plain PyTorch version in :mod:`.ref`; a
CUDA tensor launches the hand-written kernel (:mod:`.kernel`; packing
through the bit-plane pack kernel) or raises.  There is no other route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitplane.ops import pack_raw
from repro_torch.kernels.bitplane_matmul import kernel as K
from repro_torch.kernels.bitplane_matmul import ref as R


def pack_weights(w: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """(K, N) bf16 -> (bits, K, N/8) uint8 planes (store-path transform;
    on hardware this happens once at weight upload)."""
    k, n = w.shape
    if n % 8 != 0:
        raise ValueError(f"N must be a multiple of 8, got {n}")
    u = w.to(torch.bfloat16).contiguous().view(torch.int16).reshape(-1)
    return pack_raw(u, bits).reshape(bits, k, n // 8)


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor, keep: int = 16,
                    bits: int = 16) -> torch.Tensor:
    """x (M, K) bf16 × plane-packed weights -> (M, N) float32; the weight
    is read at ``keep`` planes."""
    if x.device.type == "cpu":
        return R.bitplane_matmul_ref(x, planes, keep, bits)
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on cpu or cuda tensors, got {x.device}")
    return K.bitplane_matmul(x.contiguous(), planes.contiguous(), keep=keep, bits=bits)


def weight_fetch_bytes(planes: torch.Tensor, keep: int) -> int:
    """Device bytes a ``keep``-plane fetch moves — the roofline's memory term."""
    _, k, n8 = planes.shape
    return keep * k * n8
