"""Byte-level tokenizer (the port's copy of the reference's
``data/tokenizer.py``; no vocabulary file is fetched).

Vocabulary: 256 byte values + specials.  For archs with larger vocabs the
loader re-buckets bytes into n-gram hash tokens so the embedding table is
actually exercised across its range (relevant for the vocab-sharded
embedding path)."""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIALS = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int = 259):
        assert vocab_size >= 256 + N_SPECIALS
        self.vocab_size = vocab_size

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else text
        toks = np.frombuffer(data, np.uint8).astype(np.int32) + N_SPECIALS
        if self.vocab_size > 512:
            # spread across the table with a position-salted bigram hash so
            # large embedding tables see realistic index dispersion
            shifted = np.roll(toks, 1)
            shifted[0] = BOS
            toks = (toks * 31 + shifted * 131) % (self.vocab_size - N_SPECIALS)
            toks = toks + N_SPECIALS
        return np.concatenate([[BOS], toks, [EOS]]).astype(np.int32)

    def decode_bytes(self, tokens: np.ndarray) -> bytes:
        """Inverse only for the pure-byte vocab (<=512)."""
        assert self.vocab_size <= 512
        body = tokens[(tokens >= N_SPECIALS)] - N_SPECIALS
        return body.astype(np.uint8).tobytes()
