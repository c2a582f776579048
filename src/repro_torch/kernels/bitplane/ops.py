"""Bit-plane pack and unpack (port of the reference's
``kernels/bitplane/ops.py``): the dispatch on raw bits, and value-space
entry points (bf16/fp16/fp32/fp8/int tensors in, plane arrays out).

Dispatch: a CPU tensor takes the plain PyTorch version in :mod:`.ref`; a
CUDA tensor launches the hand-written kernel (:mod:`.kernel`) or raises.
There is no other route.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.bitplane import FloatSpec
from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ref as R

#: one plane row of the reference's compression block: 4096 bytes, i.e.
#: 8 * 4096 values per block (the paper's 4 KB block)
DEFAULT_BLOCK_BYTES = 4096

#: torch dtype whose raw bits each spec describes (int4 values sit in the
#: low nibble of a uint8)
VALUE_DTYPES = {
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp32": torch.float32,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "int4": torch.uint8,
}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"bit-plane kernels run on cpu or cuda tensors, got {t.device}")


def pack_raw(u: torch.Tensor, bits: int) -> torch.Tensor:
    """(m,) raw bits (``uint8``/``int16``/``int32`` containers), m % 8 == 0
    -> (bits, m/8) uint8 planes."""
    if _on_cpu(u):
        return R.pack_ref(u, bits)
    return K.pack(u.contiguous(), bits)


def unpack_raw(planes: torch.Tensor, bits: int, keep: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(n >= keep, m/8) uint8 planes -> (m,) raw bits in ``dtype``, rebuilt
    from planes [0, keep) only."""
    if _on_cpu(planes):
        return R.unpack_ref(planes, bits, keep, dtype)
    return K.unpack(planes[:keep].contiguous(), bits, keep, dtype)


def _container(spec: FloatSpec) -> torch.dtype:
    return K.CONTAINERS[max(1, spec.bits // 8)]


def pack(x: torch.Tensor, spec: FloatSpec,
         block_bytes: int = DEFAULT_BLOCK_BYTES) -> tuple:
    """Tensor -> (planes (bits, padded/8) uint8, n_values).

    The values are padded with zeros to a whole number of compression
    blocks of ``8 * block_bytes`` values, as the reference pads them."""
    u = x.contiguous().view(_container(spec)).reshape(-1)
    n = u.numel()
    rem = (-n) % (8 * block_bytes)
    if rem:
        u = torch.cat([u, torch.zeros(rem, dtype=u.dtype, device=u.device)])
    return pack_raw(u, spec.bits), n


def unpack(planes: torch.Tensor, spec: FloatSpec, shape,
           keep: int | None = None) -> torch.Tensor:
    """Planes -> tensor of ``shape`` (top-``keep``-plane truncation applied
    when keep < bits — the memory-side meaning of FP-k)."""
    keep = spec.bits if keep is None else keep
    u = unpack_raw(planes, spec.bits, keep, _container(spec))
    n = math.prod(shape)
    return u[:n].view(VALUE_DTYPES[spec.name]).reshape(shape)
