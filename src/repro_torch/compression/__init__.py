"""Lossless block codecs used by the compression-aware memory controller.

The paper evaluates LZ4 and ZSTD with 4 KB compression blocks (Section IV.A).
``zstd`` wraps the real ``zstandard`` library (bitstream-exact with the paper's
tooling) when it is installed; ``lz4`` is a from-scratch implementation of the
LZ4 *block format* (there is no lz4 binding in this environment, and the
paper's premise is that the codec is simple enough to live in a memory
controller — implementing it is part of the reproduction).

``zstandard`` is optional: on a bare environment only ``lz4`` registers and
:func:`default_codec` falls back to it, so ``repro_torch.core`` imports everywhere.
"""

from repro_torch.compression.interface import (
    Codec,
    get_codec,
    available_codecs,
    register_codec,
)
from repro_torch.compression import lz4, zstd  # noqa: F401  (register built-ins)


def have_zstd() -> bool:
    """True when the optional ``zstandard`` library is installed."""
    return zstd.available()


def default_codec() -> str:
    """Preferred codec name for store defaults: zstd when available, else the
    dependency-free lz4 implementation (ratios within ~2x on plane data)."""
    return "zstd" if zstd.available() else "lz4"


__all__ = [
    "Codec",
    "get_codec",
    "available_codecs",
    "register_codec",
    "default_codec",
    "have_zstd",
]
