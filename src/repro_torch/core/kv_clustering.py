"""Cross-token KV cache clustering and de-correlation (paper §III.B).

The tensor counterparts of the reference's jnp functions, on raw bits in
the bit-plane containers (``uint8``, ``int16``, ``int32``), on whatever
device the input lies on.  Each step is lossless and invertible:

1. **Channel-wise grouping across tokens** (Fig. 6 ①): within a group of
   ``group`` tokens the KV tensor is transposed from token-major
   ``(group, channels)`` to channel-major ``(channels, group)``.
2. **Exponent delta transform** (Fig. 6 ③, eq. 6-7): per channel, the group
   minimum exponent is subtracted from every token's exponent — the
   exponent-delta kernel on a CUDA tensor, its plain version on the CPU.
   The paper's alternative, XOR with the previous token, and grouping alone
   are plain tensor ops (the reference has no kernel for them).  The
   encode takes the token-major tokens and does step 1 itself.
3. **Bit-plane disaggregation** is then applied by the block store.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitplane import FloatSpec
from repro_torch.kernels.exp_delta import ops as exp_delta_ops

DEFAULT_GROUP = 16  # tokens per group == paper's page size


def pad_tail(kv: torch.Tensor, group: int) -> torch.Tensor:
    """(..., t, C) -> (..., ceil(t / group) * group, C): a ragged tail group
    padded by repeating token t - 1 (repetition keeps the pad out of the
    delta statistics).  Returns ``kv`` itself when t is whole groups."""
    pad = (-kv.shape[-2]) % group
    if not pad:
        return kv
    tail = kv[..., -1:, :].expand(*kv.shape[:-2], pad, kv.shape[-1])
    return torch.cat([kv, tail], dim=-2)


def cluster(kv: torch.Tensor, group: int = DEFAULT_GROUP) -> torch.Tensor:
    """(..., t, C) token-major -> (..., ceil(t / group), C, group)
    channel-major groups, contiguous, the tail group padded
    (:func:`pad_tail`)."""
    p = pad_tail(kv, group)
    return p.unflatten(-2, (p.shape[-2] // group, group)).transpose(-1, -2).contiguous()


def uncluster(grouped: torch.Tensor) -> torch.Tensor:
    g, c, n = grouped.shape
    return grouped.permute(0, 2, 1).reshape(g * n, c)


def exp_delta_decode(encoded: torch.Tensor, base: torch.Tensor,
                     spec: FloatSpec) -> torch.Tensor:
    g = encoded.shape[-1]
    return exp_delta_ops.decode(encoded.reshape(-1, g), base.reshape(-1),
                                spec).reshape(encoded.shape)


def xor_encode(u: torch.Tensor) -> torch.Tensor:
    """XOR each token with its predecessor along the last axis (first kept)."""
    out = u.clone()
    out[..., 1:] = u[..., 1:] ^ u[..., :-1]
    return out


def xor_decode(encoded: torch.Tensor) -> torch.Tensor:
    """Cumulative XOR along the last axis (a doubling prefix scan)."""
    out, step = encoded.clone(), 1
    while step < out.shape[-1]:
        prev = out.clone()
        out[..., step:] ^= prev[..., :-step]
        step *= 2
    return out


def cluster_and_encode(
    kv_u: torch.Tensor, spec: FloatSpec, group: int = DEFAULT_GROUP,
    mode: str = "delta",
) -> tuple:
    """(..., tokens, channels) raw bits -> (encoded grouped bits (...,
    n_groups, channels, group), bases (..., n_groups, channels) uint8); a
    ragged tail group is padded by repeating the last token.

    ``mode``: 'delta' (exponent delta, default: on a CUDA tensor one kernel
    launch reads the token-major view in place and writes the groups;
    an integer spec, which has no exponent, is grouped only), 'xor', or
    'none' (grouping only — the paper's grouping-without-de-correlation
    ablation).
    """
    if mode not in ("delta", "xor", "none"):
        raise ValueError(f"unknown de-correlation mode {mode!r}")
    if mode == "delta" and spec.exp_bits:
        return exp_delta_ops.cluster_encode(kv_u, spec, group)
    grouped = cluster(kv_u, group)
    zeros = torch.zeros(grouped.shape[:-1], dtype=torch.uint8, device=grouped.device)
    return (xor_encode(grouped) if mode == "xor" else grouped), zeros


def decode_and_uncluster(
    encoded: torch.Tensor, base: torch.Tensor, spec: FloatSpec,
    mode: str = "delta",
) -> torch.Tensor:
    """The inverse of :func:`cluster_and_encode`: -> (tokens, channels)."""
    if mode == "delta":
        grouped = exp_delta_decode(encoded, base, spec)
    elif mode == "xor":
        grouped = xor_decode(encoded)
    elif mode == "none":
        grouped = encoded
    else:
        raise ValueError(f"unknown de-correlation mode {mode!r}")
    return uncluster(grouped)
