"""Hand-written Hopper kernel for Mamba2's chunked SSD scan: the binding
and the launch wrapper.

The CUDA C++ source is ``src/repro_torch/csrc/ssd.cu``, built at first use
by :mod:`repro_torch.kernels._build`.  Nothing is built when this module is
imported.  The wrapper checks its inputs, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch did
not happen, and adds one to its count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "ssd.cu"

#: dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

#: launches since the last :func:`reset_launches`
LAUNCHES = {"ssd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.ssd_launch.restype = i
    lib.ssd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd(xdt: torch.Tensor, da: torch.Tensor, b_h: torch.Tensor,
        c_h: torch.Tensor, h0: torch.Tensor, *, chunk: int):
    """xdt (B, L, H, P); da (B, L, H); b_h/c_h (B, L, H, N); h0
    (B, H, N, P); all float32, contiguous, 16-byte aligned, on one CUDA
    device; L a multiple of ``chunk``; N and P multiples of 4.  Returns
    (y (B, L, H, P), h_final (B, H, N, P)) float32."""
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if xdt.dim() != 4 or b_h.dim() != 4:
        raise ValueError(f"xdt (B, L, H, P) and b_h (B, L, H, N), got "
                         f"{tuple(xdt.shape)} and {tuple(b_h.shape)}")
    bsz, l, h, p = xdt.shape
    n = b_h.shape[-1]
    if chunk <= 0 or l % chunk:
        raise ValueError(f"L={l} must be a positive multiple of chunk={chunk}")
    if n % 4 or p % 4:
        raise ValueError(f"N={n} and P={p} must be multiples of 4")
    for name, t, shape in (("xdt", xdt, (bsz, l, h, p)), ("da", da, (bsz, l, h)),
                           ("b_h", b_h, (bsz, l, h, n)), ("c_h", c_h, (bsz, l, h, n)),
                           ("h0", h0, (bsz, h, n, p))):
        check(name, t, torch.float32, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    smem = _library().ssd_smem_bytes(n, p, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n}, P={p}, chunk={chunk} need {smem} B of shared "
                         f"memory per block, above {MAX_SMEM_BYTES}")
    y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=dev)
    h_final = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    if bsz * h == 0:
        return y, h_final
    err = _library().ssd_launch(
        xdt.data_ptr(), da.data_ptr(), b_h.data_ptr(), c_h.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_final.data_ptr(), bsz, l, h, p, n, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return y, h_final
