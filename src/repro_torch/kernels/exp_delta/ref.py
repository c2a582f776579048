"""Plain PyTorch versions of the exponent-delta encode and decode (the
reference's ``kernels/exp_delta/ref.py``), on raw bits in the integer
containers of :mod:`.kernel`, and of the fused cluster-and-encode of a
token-major view (the reference's ``core/kv_clustering.py``
``cluster_and_encode_np`` after the store's tail pad): the port's own
grouping, ``core/kv_clustering.py`` ``cluster``, then the encode.

The arithmetic runs on values widened to ``int64`` and masked to their
container's width, so a 16-bit pattern that rides in ``int16`` never
sign-extends into its exponent field; results narrow back to the input's
container, two's-complement.  ``ops.py`` runs them for CPU tensors; the
chip smoke script holds each kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import kv_clustering


def _widen(u: torch.Tensor) -> torch.Tensor:
    return u.to(torch.int64) & ((1 << 8 * u.element_size()) - 1)


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Non-negative int64 below 2**(8 * width) -> the container's bits."""
    top = 8 * torch.empty((), dtype=dtype).element_size()
    if dtype != torch.uint8 and top < 64:
        x = torch.where(x >= 1 << (top - 1), x - (1 << top), x)
    return x.to(dtype)


def encode_ref(u: torch.Tensor, man_bits: int, exp_mask: int) -> tuple:
    """(..., G) raw bits -> (encoded (..., G) in u's container, base (...,)
    uint8), along the last axis."""
    wide = _widen(u)
    exp = (wide >> man_bits) & exp_mask
    base = exp.amin(dim=-1)
    field = exp_mask << man_bits
    enc = (wide & ~field) | ((exp - base[..., None]) << man_bits)
    return _narrow(enc, u.dtype), base.to(torch.uint8)


def decode_ref(enc: torch.Tensor, base: torch.Tensor, man_bits: int,
               exp_mask: int) -> torch.Tensor:
    """The inverse of :func:`encode_ref`: exponent fields plus the base,
    modulo the field width."""
    wide = _widen(enc)
    exp = (((wide >> man_bits) & exp_mask) + base.to(torch.int64)[..., None]) & exp_mask
    field = exp_mask << man_bits
    return _narrow((wide & ~field) | (exp << man_bits), enc.dtype)


def cluster_encode_ref(u: torch.Tensor, group: int, man_bits: int,
                       exp_mask: int) -> tuple:
    """(..., t, C) token-major raw bits -> (encoded (..., ceil(t / group), C,
    group), base (..., ceil(t / group), C) uint8): pad, cluster, encode."""
    return encode_ref(kv_clustering.cluster(u, group), man_bits, exp_mask)
