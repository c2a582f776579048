"""Hand-written Hopper kernel for the matrix product with bit-plane
weights: the binding and the launch wrapper.

The CUDA C++ source is ``src/repro_torch/csrc/bitplane_matmul.cu``, built
at first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.  The wrapper checks its inputs, allocates its
output with ``torch.empty``, launches on the current stream, raises if the
launch did not happen, and adds one to its count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "bitplane_matmul.cu"

#: launches since the last :func:`reset_launches`
LAUNCHES = {"bitplane_matmul": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bitplane_matmul_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.bitplane_matmul_launch.restype = i
    return lib


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor, *, keep: int,
                    bits: int = 16) -> torch.Tensor:
    """x (M, K) bf16 × weight planes (bits, K, N/8) uint8 -> (M, N)
    float32; the weight is rebuilt from planes [0, keep) only."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or planes.dim() != 3:
        raise ValueError(f"x (M, K) and planes (bits, K, N/8), got {tuple(x.shape)} "
                         f"and {tuple(planes.shape)}")
    if not 0 < bits <= 16:
        raise ValueError(f"weights are 16-bit patterns; bits={bits}")
    if not 0 <= keep <= bits:
        raise ValueError(f"keep must be in [0, {bits}], got {keep}")
    m, k = x.shape
    n = planes.shape[2] * 8
    check("x", x, torch.bfloat16, (m, k), x.device)
    check("planes", planes, torch.uint8, (bits, k, n // 8), x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    err = _library().bitplane_matmul_launch(
        x.data_ptr(), planes.data_ptr(), out.data_ptr(), m, k, n, bits, keep,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "bitplane_matmul")
    LAUNCHES["bitplane_matmul"] += 1
    return out
