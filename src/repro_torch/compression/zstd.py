"""ZSTD codec via the real ``zstandard`` library (bitstream-exact with the
paper's tooling).  Level 3 is the zstd CLI default, which is what "ZSTD"
means in the paper's tables unless stated otherwise.

``zstandard`` is an *optional* dependency, and the port never imports it
when this module is imported: the codec registers only when the package is
installed, and the library is loaded at the first compress/decompress.  On
a bare environment ``available()`` is False and the from-scratch LZ4 codec
is the default.  Blobs are the reference's, byte for byte.
"""

# accounting-taint is suppressed line by line below: this module is the
# port's counterpart of repro/compression/, which the rule's allow-list exempts.

from __future__ import annotations

import functools
import importlib
import importlib.util

from repro_torch.compression.interface import Codec, register_codec

_LEVEL = 3


def available() -> bool:
    """True when the ``zstandard`` library is installed (found, not
    imported)."""
    return importlib.util.find_spec("zstandard") is not None


@functools.cache
def _contexts():
    """One compressor/decompressor pair reused across calls (the store path
    is single-threaded)."""
    if not available():
        raise ModuleNotFoundError(
            "the 'zstd' codec requires the optional 'zstandard' package; the "
            "built-in 'lz4' codec needs no third-party library"
        )
    z = importlib.import_module("zstandard")
    return (z.ZstdCompressor(level=_LEVEL, write_content_size=True),
            z.ZstdDecompressor())


def compress(data: bytes) -> bytes:
    return _contexts()[0].compress(data)  # repro-lint: disable=accounting-taint


def decompress(data: bytes) -> bytes:
    return _contexts()[1].decompress(data)  # repro-lint: disable=accounting-taint


CODEC = (register_codec(Codec(name="zstd", compress=compress,
                              decompress=decompress, engine="zstd"))
         if available() else None)
