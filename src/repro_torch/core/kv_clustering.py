"""Cross-token KV cache clustering and de-correlation (paper §III.B).

The NumPy functions the compressed store calls, copied from the reference
(``cluster_and_encode_np`` / ``decode_and_uncluster_np`` and their helpers).
Each step is lossless and invertible:

1. **Channel-wise grouping across tokens** (Fig. 6 ①): within a group of
   ``group`` tokens the KV tensor is transposed from token-major
   ``(group, channels)`` to channel-major ``(channels, group)``.
2. **Exponent delta transform** (Fig. 6 ③, eq. 6-7): per channel, the group
   minimum exponent is subtracted from every token's exponent.
3. **Bit-plane disaggregation** is then applied by the block store.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitplane import FloatSpec

DEFAULT_GROUP = 16  # tokens per group == paper's page size


def cluster_np(kv: np.ndarray, group: int = DEFAULT_GROUP) -> np.ndarray:
    """(tokens, channels) -> (n_groups, channels, group), channel-major.

    ``tokens`` must be a multiple of ``group`` (callers pad the tail group).
    """
    t, c = kv.shape
    assert t % group == 0, f"token count {t} not a multiple of group {group}"
    return np.ascontiguousarray(kv.reshape(t // group, group, c).transpose(0, 2, 1))


def uncluster_np(grouped: np.ndarray) -> np.ndarray:
    g, c, n = grouped.shape
    return np.ascontiguousarray(grouped.transpose(0, 2, 1)).reshape(g * n, c)


def exp_delta_encode_np(
    u: np.ndarray, spec: FloatSpec
) -> tuple[np.ndarray, np.ndarray]:
    """Delta-encode exponents along the last (token) axis.

    ``u``: (..., channels, group) raw uint view.  Returns (encoded, base)
    where ``base`` is (..., channels) uint8 — the per-channel base exponent
    beta_j (eq. 6).  Integer specs pass through unchanged with empty bases.
    """
    if spec.exp_bits == 0:
        return u, np.zeros(u.shape[:-1], np.uint8)
    exp = (u >> spec.man_bits) & spec.exp_mask
    base = exp.min(axis=-1)
    delta = exp - base[..., None]
    encoded = (u & ~np.array(spec.exp_mask << spec.man_bits, u.dtype)) | (
        delta.astype(u.dtype) << spec.man_bits
    )
    return encoded, base.astype(np.uint8)


def exp_delta_decode_np(
    encoded: np.ndarray, base: np.ndarray, spec: FloatSpec
) -> np.ndarray:
    if spec.exp_bits == 0:
        return encoded
    delta = (encoded >> spec.man_bits) & spec.exp_mask
    exp = delta + base[..., None].astype(encoded.dtype)
    return (encoded & ~np.array(spec.exp_mask << spec.man_bits, encoded.dtype)) | (
        (exp & spec.exp_mask).astype(encoded.dtype) << spec.man_bits
    )


def xor_encode_np(u: np.ndarray) -> np.ndarray:
    """XOR each token with its predecessor along the last axis (first kept)."""
    out = u.copy()
    out[..., 1:] = u[..., 1:] ^ u[..., :-1]
    return out


def xor_decode_np(encoded: np.ndarray) -> np.ndarray:
    return np.bitwise_xor.accumulate(encoded, axis=-1)


def cluster_and_encode_np(
    kv_u: np.ndarray, spec: FloatSpec, group: int = DEFAULT_GROUP,
    mode: str = "delta",
) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, channels) uint view -> (encoded grouped uints, bases).

    ``mode``: 'delta' (exponent delta, default), 'xor', or 'none' (grouping
    only — the paper's grouping-without-de-correlation ablation).
    """
    grouped = cluster_np(kv_u, group)  # (G, C, group)
    if mode == "delta":
        return exp_delta_encode_np(grouped, spec)
    if mode == "xor":
        return xor_encode_np(grouped), np.zeros(grouped.shape[:-1], np.uint8)
    if mode == "none":
        return grouped, np.zeros(grouped.shape[:-1], np.uint8)
    raise ValueError(f"unknown de-correlation mode {mode!r}")


def decode_and_uncluster_np(
    encoded: np.ndarray, base: np.ndarray, spec: FloatSpec, mode: str = "delta"
) -> np.ndarray:
    if mode == "delta":
        grouped = exp_delta_decode_np(encoded, base, spec)
    elif mode == "xor":
        grouped = xor_decode_np(encoded)
    elif mode == "none":
        grouped = encoded
    else:
        raise ValueError(f"unknown de-correlation mode {mode!r}")
    return uncluster_np(grouped)
