"""Hand-written Hopper kernels for bit-plane paged decode attention: the
binding and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/paged_attention.cu``, built
at first use by :mod:`repro_torch.kernels._build`.  Nothing is built or
imported when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch did not happen, and adds one to its count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "paged_attention.cu"

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"paged_attention_fused": 0, "paged_attention_rung": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                 i, i, f, p]
    lib.paged_attention_fused_launch.restype = i
    lib.paged_attention_rung_launch.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, i, i, f, p]
    lib.paged_attention_rung_launch.restype = i
    return lib


def _geometry(q, k_planes, v_planes, mask, bits):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, hkv, rep, hd = q.shape
    if hd % 8 != 0:
        raise ValueError(f"head_dim must be a multiple of 8, got {hd}")
    s = k_planes.shape[2]
    if s % 16 != 0:
        raise ValueError(f"the kernel walks 16-token pages; S={s} is not a multiple")
    check("q", q, torch.bfloat16, (b, hkv, rep, hd), q.device)
    for name, t in (("k_planes", k_planes), ("v_planes", v_planes)):
        check(name, t, torch.uint8, (bits, b, s, hkv, hd // 8), q.device)
    check("mask", mask, torch.int8, (b, s), q.device)
    return b, s, hkv, rep, hd


def paged_attention_fused(q, k_planes, v_planes, page_keeps, mask, *,
                          bits: int = 16, page_tokens: int = 16):
    """Normalised attention output (B, Hkv, rep, hd) float32 over the
    mixed-precision cache; page p of row b reads planes [0, page_keeps[b, p])."""
    if page_tokens != 16:
        raise ValueError(f"the kernel's pages are 16 tokens, got {page_tokens}")
    b, s, hkv, rep, hd = _geometry(q, k_planes, v_planes, mask, bits)
    check("page_keeps", page_keeps, torch.int32, (b, s // 16), q.device)
    out = torch.empty((b, hkv, rep, hd), dtype=torch.float32, device=q.device)
    err = _library().paged_attention_fused_launch(
        q.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(),
        page_keeps.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, s, hkv, rep, hd, bits, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on(err, "paged_attention_fused")
    LAUNCHES["paged_attention_fused"] += 1
    return out


def paged_attention_rung(q, k_planes, v_planes, mask, *, keep: int,
                         bits: int = 16):
    """Unnormalised partials (o (B, Hkv, rep, hd), m, l (B, Hkv, rep))
    float32 of one precision rung: every masked-in token at ``keep`` planes."""
    b, s, hkv, rep, hd = _geometry(q, k_planes, v_planes, mask, bits)
    if not 0 < keep <= bits:
        raise ValueError(f"keep must be in [1, {bits}], got {keep}")
    o = torch.empty((b, hkv, rep, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, rep), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, rep), dtype=torch.float32, device=q.device)
    err = _library().paged_attention_rung_launch(
        q.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(),
        mask.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, s, hkv, rep, hd, bits, keep, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on(err, "paged_attention_rung")
    LAUNCHES["paged_attention_rung"] += 1
    return o, m, l
