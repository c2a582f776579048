"""Codec registry.

A ``Codec`` is a pair of pure ``bytes -> bytes`` functions plus a tiny amount of
metadata used by the hardware cost model (the paper's Table IV models LZ4 and
ZSTD engines separately).  Codecs must be *block* codecs: every ``compress``
output must be decodable in isolation (no inter-block state), mirroring the
paper's 2/4 KB block-based hardware engine.
"""

# accounting-taint is suppressed line by line below: this module is the
# port's counterpart of repro/compression/, which the rule's allow-list exempts.

from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    # Relative silicon complexity class used by memsim.hardware (Table IV).
    engine: str = "generic"

    def ratio(self, data: bytes) -> float:
        """Compression ratio S_orig / S_comp (>= 1 means it compressed)."""
        if len(data) == 0:
            return 1.0
        comp = self.compress(data)  # repro-lint: disable=accounting-taint
        return len(data) / max(1, len(comp))


_REGISTRY: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        hint = ""
        if name.startswith("zstd"):
            hint = " (the zstd codec needs the optional 'zstandard' package)"
        raise KeyError(
            f"unknown codec {name!r}; available: {sorted(_REGISTRY)}{hint}"
        ) from None


def available_codecs() -> list[str]:
    return sorted(_REGISTRY)
