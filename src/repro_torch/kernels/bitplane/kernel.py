"""Hand-written Hopper kernels for bit-plane pack and unpack: the binding
and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/bitplane.cu``, built at
first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.

Values travel as raw bits in integer containers of 1, 2 or 4 bytes
(``uint8``, ``int16``, ``int32``: torch's arithmetic on its unsigned 16-
and 32-bit types is partial, so the 16- and 32-bit patterns ride in the
signed types of the same width).  Each wrapper checks its inputs, allocates
its output with ``torch.empty``, launches on the current stream, raises if
the launch did not happen, and adds one to its count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "bitplane.cu"

#: raw-bit container per value width in bytes
CONTAINERS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"bitplane_pack": 0, "bitplane_unpack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitplane_pack_launch.argtypes = [p, p, ll, i, i, p]
    lib.bitplane_pack_launch.restype = i
    lib.bitplane_unpack_launch.argtypes = [p, p, ll, i, i, i, p]
    lib.bitplane_unpack_launch.restype = i
    return lib


def _width(dtype: torch.dtype, bits: int) -> int:
    widths = {t: w for w, t in CONTAINERS.items()}
    if dtype not in widths:
        raise TypeError(f"raw bits ride in {list(CONTAINERS.values())}, got {dtype}")
    if not 0 < bits <= 8 * widths[dtype]:
        raise ValueError(f"{bits} bits do not fit a {dtype} container")
    return widths[dtype]


def pack(u: torch.Tensor, bits: int) -> torch.Tensor:
    """(m,) raw bits, m % 8 == 0 -> (bits, m/8) uint8 planes, plane 0 = MSB."""
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {u.device}")
    width = _width(u.dtype, bits)
    m = u.numel()
    if m % 8 != 0:
        raise ValueError(f"bit-planes pack octets of values; m={m} is not a multiple of 8")
    check("u", u, u.dtype, (m,), u.device)
    planes = torch.empty((bits, m // 8), dtype=torch.uint8, device=u.device)
    if m == 0:
        return planes
    err = _library().bitplane_pack_launch(
        u.data_ptr(), planes.data_ptr(), m // 8, width, bits,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    raise_on(err, "bitplane_pack")
    LAUNCHES["bitplane_pack"] += 1
    return planes


def unpack(planes: torch.Tensor, bits: int, keep: int,
           dtype: torch.dtype) -> torch.Tensor:
    """planes (n, m/8) uint8 with n >= keep -> (m,) raw bits in ``dtype``
    from planes [0, keep) only; the low ``bits - keep`` bits are zero."""
    if planes.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {planes.device}")
    width = _width(dtype, bits)
    if not 0 <= keep <= min(bits, planes.shape[0]):
        raise ValueError(f"keep={keep} outside [0, {min(bits, planes.shape[0])}]")
    if planes.dim() != 2:
        raise ValueError(f"planes are (n, m/8), got {tuple(planes.shape)}")
    m8 = planes.shape[1]
    check("planes", planes, torch.uint8, (planes.shape[0], m8), planes.device)
    out = torch.empty((m8 * 8,), dtype=dtype, device=planes.device)
    if m8 == 0:
        return out
    err = _library().bitplane_unpack_launch(
        planes.data_ptr(), out.data_ptr(), m8, width, bits, keep,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    raise_on(err, "bitplane_unpack")
    LAUNCHES["bitplane_unpack"] += 1
    return out
