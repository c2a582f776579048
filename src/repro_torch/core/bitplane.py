"""Bit-plane disaggregation (paper §III.A).

A block of ``m`` n-bit values is reorganised so that bit position ``i`` of all
values is stored contiguously (bit-plane ``P_i``), creating a bit-level
column-store.  Plane 0 is the MOST significant bit (sign), plane n-1 the least
significant mantissa bit, so "fetch the top-k planes" is ``planes[:k]`` —
exactly the partial-plane dynamic-quantization fetch of Fig. 5.

The NumPy half is the reference's, copied (the host-side compressed store
runs on it).  The port imports no ``ml_dtypes``: bf16 values cross into
NumPy as their ``uint16`` bit patterns (:func:`bf16_to_numpy`), and
``from_uint_np`` hands bf16 back the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """Bit layout of a storage format: 1 sign + E exponent + F mantissa bits.

    Integer formats use ``exp_bits=0`` (the exponent-delta transform becomes a
    no-op for them, mirroring the paper's INT4/INT8 rows in Table III).
    """

    name: str
    bits: int
    exp_bits: int
    man_bits: int

    def __post_init__(self):
        assert self.bits in (4, 8, 16, 32)
        if self.exp_bits:
            assert 1 + self.exp_bits + self.man_bits == self.bits

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def uint_np(self):
        return {4: np.uint8, 8: np.uint8, 16: np.uint16, 32: np.uint32}[self.bits]

    @property
    def value_np(self):
        """NumPy dtype whose raw bits this spec describes; None where NumPy
        has no such dtype (bf16, fp8, int4), whose values stay uint views."""
        return {
            "fp16": np.float16,
            "fp32": np.float32,
            "int8": np.int8,
        }.get(self.name)


BF16 = FloatSpec("bf16", 16, 8, 7)
FP16 = FloatSpec("fp16", 16, 5, 10)
FP32 = FloatSpec("fp32", 32, 8, 23)
FP8_E4M3 = FloatSpec("fp8_e4m3", 8, 4, 3)
FP8_E5M2 = FloatSpec("fp8_e5m2", 8, 5, 2)
INT8 = FloatSpec("int8", 8, 0, 0)
INT4 = FloatSpec("int4", 4, 0, 0)

SPECS = {s.name: s for s in (BF16, FP16, FP32, FP8_E4M3, FP8_E5M2, INT8, INT4)}


# ---------------------------------------------------------------------------
# NumPy path (host-side store)
# ---------------------------------------------------------------------------


def to_uint_np(x: np.ndarray, spec: FloatSpec) -> np.ndarray:
    """Reinterpret values as their raw uint bit patterns, flattened."""
    if spec.name == "int4":
        x = np.asarray(x, np.uint8)
        assert (x < 16).all(), "int4 values must be pre-packed into low nibble"
        return x.reshape(-1)
    return np.ascontiguousarray(x).view(spec.uint_np).reshape(-1)


def from_uint_np(u: np.ndarray, spec: FloatSpec, shape) -> np.ndarray:
    if spec.name == "int4":
        return u.astype(np.uint8).reshape(shape)
    return u.astype(spec.uint_np).view(spec.value_np or spec.uint_np).reshape(shape)


def disaggregate_np(u: np.ndarray, bits: int) -> np.ndarray:
    """(m,) uint -> (bits, m//8) uint8 planes, MSB-first. m must be %8 == 0."""
    m = u.shape[0]
    assert m % 8 == 0, f"bit-plane block length must be a multiple of 8, got {m}"
    shifts = np.arange(bits - 1, -1, -1, dtype=u.dtype)
    planes_bits = ((u[None, :] >> shifts[:, None]) & 1).astype(np.uint8)
    return np.packbits(planes_bits, axis=1)  # MSB-first inside each byte


def reaggregate_np(planes: np.ndarray, bits: int, keep: int | None = None) -> np.ndarray:
    """(bits, m//8) uint8 planes -> (m,) uint.

    ``keep`` < bits emulates a partial-plane fetch: only the top ``keep``
    planes contribute; the rest are zero (truncation quantization).
    """
    keep = bits if keep is None else keep
    m = planes.shape[1] * 8
    out_dtype = np.uint32 if bits > 16 else (np.uint16 if bits > 8 else np.uint8)
    u = np.zeros(m, dtype=np.uint32)
    for i in range(keep):
        bits_row = np.unpackbits(planes[i])
        u |= bits_row.astype(np.uint32) << np.uint32(bits - 1 - i)
    return u.astype(out_dtype)


# ---------------------------------------------------------------------------
# torch path (device side): bf16 <-> raw 16-bit patterns
# ---------------------------------------------------------------------------


def from_uint(u: torch.Tensor) -> torch.Tensor:
    """Raw 16-bit patterns (any integer dtype) -> bf16 tensor."""
    return u.to(torch.int32).to(torch.int16).view(torch.bfloat16)


def bf16_to_numpy(x: torch.Tensor) -> np.ndarray:
    """bf16 tensor (any device) -> NumPy ``uint16`` array of its bit patterns
    — how bf16 reaches the host-side store without ``ml_dtypes``."""
    return x.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
