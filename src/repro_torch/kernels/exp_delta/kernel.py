"""Hand-written Hopper kernels for the exponent-delta transform: the
binding and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/exp_delta.cu``, built at
first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.

Rows of ``G <= 32`` raw values travel in the bit-plane kernels' integer
containers (``uint8``, ``int16``, ``int32``).  Each wrapper checks its
inputs, allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch did not happen, and adds one to its count in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import aligned, check, load, raise_on
from repro_torch.kernels.bitplane.kernel import CONTAINERS

SOURCE = "exp_delta.cu"

#: the longest row (tokens per channel group) the kernels take
MAX_GROUP = 32

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"exp_delta_encode": 0, "exp_delta_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.exp_delta_encode_launch, lib.exp_delta_decode_launch):
        fn.argtypes = [p, p, p, ll, i, i, i, i, p]
        fn.restype = i
    return lib


def _rows(name: str, t: torch.Tensor) -> tuple:
    """(R, G, container width) of a raw-bit row tensor on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {t.device}")
    widths = {d: w for w, d in CONTAINERS.items()}
    if t.dtype not in widths:
        raise TypeError(f"raw bits ride in {list(CONTAINERS.values())}, got {t.dtype}")
    if t.dim() != 2 or not 1 <= t.shape[1] <= MAX_GROUP:
        raise ValueError(f"{name} is (R, G) with 1 <= G <= {MAX_GROUP}, got {tuple(t.shape)}")
    return t.shape[0], t.shape[1], widths[t.dtype]


def _field(width: int, man_bits: int, exp_mask: int) -> None:
    if not 0 < exp_mask <= 0xFF or (exp_mask << man_bits) >> (8 * width):
        raise ValueError(f"exponent field {exp_mask:#x} << {man_bits} does not fit "
                         f"a {width}-byte value with an 8-bit base")


def encode(u: torch.Tensor, man_bits: int, exp_mask: int) -> tuple:
    """(R, G) raw bits -> (encoded (R, G) in u's container, base (R,) uint8):
    each row's smallest exponent field is its base and is subtracted from
    every value's exponent field."""
    r, g, width = _rows("u", u)
    _field(width, man_bits, exp_mask)
    u = aligned(u)
    enc = torch.empty_like(u)
    base = torch.empty((r,), dtype=torch.uint8, device=u.device)
    if r == 0:
        return enc, base
    err = _library().exp_delta_encode_launch(
        u.data_ptr(), enc.data_ptr(), base.data_ptr(), r, g, width, man_bits,
        exp_mask, torch.cuda.current_stream(u.device).cuda_stream,
    )
    raise_on(err, "exp_delta_encode")
    LAUNCHES["exp_delta_encode"] += 1
    return enc, base


def decode(enc: torch.Tensor, base: torch.Tensor, man_bits: int,
           exp_mask: int) -> torch.Tensor:
    """(R, G) encoded raw bits and (R,) uint8 bases -> (R, G) raw bits: each
    value's exponent field plus its row's base, modulo the field."""
    r, g, width = _rows("enc", enc)
    _field(width, man_bits, exp_mask)
    enc = aligned(enc)
    check("base", base, torch.uint8, (r,), enc.device)
    out = torch.empty_like(enc)
    if r == 0:
        return out
    err = _library().exp_delta_decode_launch(
        enc.data_ptr(), base.data_ptr(), out.data_ptr(), r, g, width, man_bits,
        exp_mask, torch.cuda.current_stream(enc.device).cuda_stream,
    )
    raise_on(err, "exp_delta_decode")
    LAUNCHES["exp_delta_decode"] += 1
    return out
