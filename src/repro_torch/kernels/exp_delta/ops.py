"""Exponent-delta encode and decode (port of the reference's
``kernels/exp_delta/ops.py``): the dispatch on raw-bit rows, and on the
token-major views the store clusters and encodes in one step.

Dispatch: a CPU tensor takes the plain PyTorch version in :mod:`.ref`; a
CUDA tensor launches the hand-written kernel (:mod:`.kernel`) or raises.
There is no other route.  Integer specs (``exp_bits == 0``) pass
:func:`encode` with zero bases, as the reference's do (the store groups
them without :func:`cluster_encode`); no channel is padded (the
reference pads channels to its 256-row tile, the kernel takes any row
count).
"""

from __future__ import annotations

import torch

from repro_torch.core.bitplane import FloatSpec
from repro_torch.kernels.exp_delta import kernel as K
from repro_torch.kernels.exp_delta import ref as R


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"exponent-delta kernels run on cpu or cuda tensors, got {t.device}")


def encode(u: torch.Tensor, spec: FloatSpec) -> tuple:
    """u: (R, G) raw bits (the bit-plane containers) -> (encoded (R, G) in
    u's container, base (R,) uint8)."""
    if spec.exp_bits == 0:
        return u, torch.zeros(u.shape[:-1], dtype=torch.uint8, device=u.device)
    if _on_cpu(u):
        return R.encode_ref(u, spec.man_bits, spec.exp_mask)
    return K.encode(u, spec.man_bits, spec.exp_mask)


def cluster_encode(u: torch.Tensor, spec: FloatSpec, group: int) -> tuple:
    """u: (..., t, C) token-major raw bits (any strides, channels dense) ->
    (encoded (..., ceil(t / group), C, group) in u's container, base (...,
    ceil(t / group), C) uint8): channel-major groups of ``group`` tokens, a
    ragged tail group padded by repeating the last token, each encoded.  A
    CUDA tensor is read in place by one launch."""
    if spec.exp_bits == 0:
        raise ValueError(f"{spec.name} has no exponent to encode: group it with "
                         "core.kv_clustering.cluster")
    if _on_cpu(u):
        return R.cluster_encode_ref(u, group, spec.man_bits, spec.exp_mask)
    return K.cluster_encode(u, group, spec.man_bits, spec.exp_mask)


def decode(enc: torch.Tensor, base: torch.Tensor, spec: FloatSpec) -> torch.Tensor:
    """The inverse of :func:`encode`: (R, G) encoded raw bits and (R,) uint8
    bases -> (R, G) raw bits."""
    if spec.exp_bits == 0:
        return enc
    if _on_cpu(enc):
        return R.decode_ref(enc, base, spec.man_bits, spec.exp_mask)
    return K.decode(enc, base.contiguous(), spec.man_bits, spec.exp_mask)
