"""LZ4 *block format* codec, implemented from scratch.

The paper's hardware compression engine implements LZ4 (Table IV).  No LZ4
binding ships in this environment, so this module implements the LZ4 block
format (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md) directly:

* greedy hash-table matcher (single-cell table, 64 KB window) — the same
  strategy as the reference ``LZ4_compress_default`` fast path, which is also
  what a 1-cycle/byte hardware lane implements;
* skip-acceleration on incompressible regions (as in the reference encoder);
* format-compliant end-of-block rules (last 5 bytes literal, last match starts
  >= 12 bytes before the end), so output is decodable by any conformant LZ4
  decoder and vice versa.

Compression *ratios* produced here are therefore directly comparable with the
paper's LZ4 numbers.  Throughput is a software artifact; the hardware engine's
throughput is modeled in :mod:`repro_torch.memsim.hardware`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compression.interface import Codec, register_codec

_MINMATCH = 4
_MFLIMIT = 12  # match may not start closer than this to the end of the block
_LASTLITERALS = 5  # final bytes must be literals
_HASH_LOG = 13  # 8 K-entry table: plenty for <=64 KB blocks, matches HW budget
_HASH_MUL = np.uint32(2654435761)
_MAX_OFFSET = 65535


def _hash_positions(buf: np.ndarray) -> np.ndarray:
    """Vectorised 4-byte hash of every position (len(buf) - 3 entries)."""
    b = buf.astype(np.uint32)
    u = b[:-3] | (b[1:-2] << np.uint32(8)) | (b[2:-1] << np.uint32(16)) | (
        b[3:] << np.uint32(24)
    )
    return ((u * _HASH_MUL) >> np.uint32(32 - _HASH_LOG)).astype(np.int64)


def _write_lsic(out: bytearray, value: int) -> None:
    """Linear small-integer code: 255-continuation bytes."""
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)


def _emit(out: bytearray, literals: memoryview, offset: int, match_len: int) -> None:
    lit_len = len(literals)
    ml_code = match_len - _MINMATCH
    token = (min(lit_len, 15) << 4) | min(ml_code, 15)
    out.append(token)
    if lit_len >= 15:
        _write_lsic(out, lit_len - 15)
    out += literals
    out += offset.to_bytes(2, "little")
    if ml_code >= 15:
        _write_lsic(out, ml_code - 15)


def _emit_last_literals(out: bytearray, literals: memoryview) -> None:
    lit_len = len(literals)
    out.append(min(lit_len, 15) << 4)
    if lit_len >= 15:
        _write_lsic(out, lit_len - 15)
    out += literals


def compress(src: bytes) -> bytes:
    n = len(src)
    if n == 0:
        return b"\x00"  # single empty-literal token, as the reference encoder
    view = memoryview(src)
    out = bytearray()
    if n < _MFLIMIT + 1:
        _emit_last_literals(out, view)
        return bytes(out)

    buf = np.frombuffer(src, dtype=np.uint8)
    hashes = _hash_positions(buf)
    table = np.full(1 << _HASH_LOG, -1, dtype=np.int64)

    match_limit = n - _MFLIMIT  # last legal match start
    copy_limit = n - _LASTLITERALS  # matches may not cover the final 5 bytes
    anchor = 0
    i = 0
    miss = 0
    while i <= match_limit:
        h = hashes[i]
        ref = int(table[h])
        table[h] = i
        if (
            ref >= 0
            and i - ref <= _MAX_OFFSET
            and src[ref : ref + 4] == src[i : i + 4]
        ):
            # Extend the match backwards over pending literals.
            while i > anchor and ref > 0 and src[i - 1] == src[ref - 1]:
                i -= 1
                ref -= 1
            # Extend forwards, chunked compare then byte-tail.
            ml = _MINMATCH
            while i + ml + 16 <= copy_limit and (
                src[i + ml : i + ml + 16] == src[ref + ml : ref + ml + 16]
            ):
                ml += 16
            while i + ml < copy_limit and src[i + ml] == src[ref + ml]:
                ml += 1
            _emit(out, view[anchor:i], i - ref, ml)
            i += ml
            anchor = i
            miss = 0
        else:
            # Skip-acceleration: incompressible data advances faster.
            i += 1 + (miss >> 6)
            miss += 1
    _emit_last_literals(out, view[anchor:n])
    return bytes(out)


def decompress(comp: bytes) -> bytes:
    src = comp
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if lit_len:
            if i + lit_len > n:
                raise ValueError("lz4: literal run past end of block")
            out += src[i : i + lit_len]
            i += lit_len
        if i >= n:
            break  # final literals-only sequence
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4: zero offset")
        ml = token & 0x0F
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += _MINMATCH
        start = len(out) - offset
        if start < 0:
            raise ValueError("lz4: offset beyond output start")
        if offset >= ml:
            out += out[start : start + ml]
        else:
            # Overlapping copy (RLE-style) must be byte-serial.
            for k in range(ml):
                out.append(out[start + k])
    return bytes(out)


CODEC = register_codec(Codec(name="lz4", compress=compress, decompress=decompress, engine="lz4"))
