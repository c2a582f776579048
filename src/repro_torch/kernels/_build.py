"""Build and load the port's hand-written CUDA kernels.

Each CUDA C++ source under ``src/repro_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
first use, into ``build/kernels/`` at the repository root, under a name
keyed by a hash of the source and the flags; ``ctypes`` loads it.  Nothing
is built when a kernel module is imported.  The wrappers' shared argument
check, alignment and launch-error check live here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the sources with the longest builds, compiled with their kernels
# optimised in parallel (one thread a core): their machine code is the
# same either way, where the SSD and exponent-delta sources' is not
SPLIT_COMPILE = frozenset({"flash_attention.cu", "flash_attention_bwd.cu",
                           "paged_attention.cu"})


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
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def library_path(source: str, extra: tuple = ()) -> Path:
    """Where ``csrc/<source>`` builds to under the current flags (and
    ``extra`` ones)."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(_flags(source, extra)).encode())
    return BUILD_DIR / f"{src.stem}_{key.hexdigest()[:16]}.so"


def _flags(source: str, extra: tuple) -> tuple:
    split = ("-split-compile=0",) if source in SPLIT_COMPILE else ()
    return NVCC_FLAGS + split + extra


def build(source: str, extra: tuple = ()) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless this source and these flags (with
    ``extra`` ones, such as a ``-D`` define) were already built; returns
    the library path and the compiler's log (the register and
    shared-memory report of ``-Xptxas -v``; empty when cached)."""
    out = library_path(source, extra)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *_flags(source, extra), "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def load(source: str, extra: tuple = ()) -> ctypes.CDLL:
    """The built library of ``csrc/<source>`` (built on the first call),
    with ``extra`` flags."""
    path, _ = build(source, extra)
    return ctypes.CDLL(str(path))


def raise_on(err: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels read
    16-byte vectors); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
