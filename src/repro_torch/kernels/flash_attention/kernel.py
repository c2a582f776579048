"""Hand-written Hopper kernel for flash-attention prefill: the binding and
the launch wrapper.

The CUDA C++ source is ``src/repro_torch/csrc/flash_attention.cu``, built
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

SOURCE = "flash_attention.cu"

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)

#: launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.flash_attention_launch.restype = i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_valid: torch.Tensor, *,
                    causal: bool, window: int) -> torch.Tensor:
    """q (B, Sq, Hp, hd) bf16; k/v (B, Skv, Hkv, hd) bf16 with Hp a
    multiple of Hkv; q_pos (B, Sq) int32; kv_valid (B,) int32; all
    contiguous, 16-byte aligned, on one CUDA device; hd in
    :data:`HEAD_DIMS`.  Returns (B, Sq, Hp, hd) bf16."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q (B, Sq, Hp, hd) and k (B, Skv, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bsz, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if hkv == 0 or hp % hkv:
        raise ValueError(f"{hp} q heads over {hkv} kv heads")
    for name, t, dtype, shape in (
            ("q", q, torch.bfloat16, (bsz, sq, hp, hd)),
            ("k", k, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("v", v, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("q_pos", q_pos, torch.int32, (bsz, sq)),
            ("kv_valid", kv_valid, torch.int32, (bsz,))):
        check(name, t, dtype, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((bsz, sq, hp, hd), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(), bsz, sq, skv, hp, hkv, hd,
        int(bool(causal)), int(window), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
