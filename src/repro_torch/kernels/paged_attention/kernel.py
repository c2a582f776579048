"""Hand-written Hopper kernels for bit-plane paged decode attention: the
build, the binding, and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/paged_attention.cu``.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``build/kernels/`` at the repository root,
under a name keyed by a hash of the source and the flags; ``ctypes`` loads
it.  Nothing is built or imported when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch did not happen, and adds one to its count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "paged_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"paged_attention_fused": 0, "paged_attention_rung": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise FileNotFoundError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the paged-attention "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"paged_attention_{key.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless this source and these flags were already
    built; returns the library path and the compiler's log (the register
    and shared-memory report of ``-Xptxas -v``; empty when cached)."""
    out = library_path()
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                 i, i, f, p]
    lib.paged_attention_fused_launch.restype = i
    lib.paged_attention_rung_launch.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, i, i, f, p]
    lib.paged_attention_rung_launch.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(q, k_planes, v_planes, mask, bits):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, hkv, rep, hd = q.shape
    if hd % 8 != 0:
        raise ValueError(f"head_dim must be a multiple of 8, got {hd}")
    s = k_planes.shape[2]
    if s % 16 != 0:
        raise ValueError(f"the kernel walks 16-token pages; S={s} is not a multiple")
    _check("q", q, torch.bfloat16, (b, hkv, rep, hd), q.device)
    for name, t in (("k_planes", k_planes), ("v_planes", v_planes)):
        _check(name, t, torch.uint8, (bits, b, s, hkv, hd // 8), q.device)
    _check("mask", mask, torch.int8, (b, s), q.device)
    return b, s, hkv, rep, hd


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def paged_attention_fused(q, k_planes, v_planes, page_keeps, mask, *,
                          bits: int = 16, page_tokens: int = 16):
    """Normalised attention output (B, Hkv, rep, hd) float32 over the
    mixed-precision cache; page p of row b reads planes [0, page_keeps[b, p])."""
    if page_tokens != 16:
        raise ValueError(f"the kernel's pages are 16 tokens, got {page_tokens}")
    b, s, hkv, rep, hd = _geometry(q, k_planes, v_planes, mask, bits)
    _check("page_keeps", page_keeps, torch.int32, (b, s // 16), q.device)
    out = torch.empty((b, hkv, rep, hd), dtype=torch.float32, device=q.device)
    err = _library().paged_attention_fused_launch(
        q.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(),
        page_keeps.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, s, hkv, rep, hd, bits, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "paged_attention_fused")
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
    _raise_on(err, "paged_attention_rung")
    LAUNCHES["paged_attention_rung"] += 1
    return o, m, l
