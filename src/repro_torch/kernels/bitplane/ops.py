"""Bit-plane pack and unpack (port of the reference's
``kernels/bitplane/ops.py``): the dispatch on raw bits, and value-space
entry points (bf16/fp16/fp32/fp8/int tensors in, plane arrays out).

The KV cache's entry points move K and V together between bf16 rows and
the (bits, A, S, Hkv, hd/8) plane cache: :func:`pack_kv_into` writes the
planes in place, :func:`unpack_kv_pair` rebuilds both streams' rows.

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


def pack_kv_into(k: torch.Tensor, v: torch.Tensor, k_planes: torch.Tensor,
                 v_planes: torch.Tensor, start) -> None:
    """K and V rows (A, c, Hkv, hd) bf16 into their plane caches (bits, A,
    S, Hkv, hd/8) uint8, IN PLACE: rows [start, start + c) for a Python
    ``start``, row a's token at clamp(start[a], 0, S - 1) for an (A,)
    tensor.  One launch on CUDA."""
    if _on_cpu(k_planes):
        return R.pack_kv_into_ref(k, v, k_planes, v_planes, start)
    return K.pack_kv_into(k, v, k_planes, v_planes, start)


def unpack_kv_pair(k_planes: torch.Tensor, v_planes: torch.Tensor, keep: int,
                   bits: int = 16) -> torch.Tensor:
    """K and V planes (n >= keep, A, B, Hkv, hd/8) -> (2, A, B, Hkv, hd)
    bf16 from planes [0, keep).  One launch on CUDA."""
    if _on_cpu(k_planes):
        return R.unpack_kv_pair_ref(k_planes, v_planes, keep, bits)
    return K.unpack_kv_pair(k_planes, v_planes, keep, bits)


def container(spec: FloatSpec) -> torch.dtype:
    """The raw-bit container of a spec's values (int4 in a uint8)."""
    return K.CONTAINERS[max(1, spec.bits // 8)]


def pack(x: torch.Tensor, spec: FloatSpec,
         block_bytes: int = DEFAULT_BLOCK_BYTES) -> tuple:
    """Tensor -> (planes (bits, padded/8) uint8, n_values).

    The values are padded with zeros to a whole number of compression
    blocks of ``8 * block_bytes`` values, as the reference pads them."""
    u = x.contiguous().view(container(spec)).reshape(-1)
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
    u = unpack_raw(planes, spec.bits, keep, container(spec))
    n = math.prod(shape)
    return u[:n].view(VALUE_DTYPES[spec.name]).reshape(shape)
