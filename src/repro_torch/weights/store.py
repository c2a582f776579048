"""Block-compressed per-layer weight store (port of the reference's
``weights/store.py``).

Ingest dataflow (per layer handle from
:func:`repro_torch.models.transformer.split_layer_params`):

    handle -> (name, tensor) pairs -> one device->host copy of each tensor's
           raw bits, flattened
           -> [sharded: contiguous 1/n slice for this tier]
           -> pad to a whole lane stripe (``StoreConfig.values_per_segment``
              values — one bit-plane of one segment is exactly one
              ``block_bytes`` stripe, the lane engine's transfer unit)
           -> ``MemoryController.write_weights(..., valid_values=)``

The compression runs on the host, as the reference's does: the store holds
what the controller's codec made of the exact bits the model computes
with.  Padding is physically stored (the stripes are real) but never
logical data: every savings/bandwidth number downstream is quoted against
``valid_logical_bytes`` via ``CompressedTensor.exact_savings``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.bitplane import (
    BF16,
    FP8_E4M3,
    FP8_E5M2,
    FP16,
    FP32,
    INT8,
    FloatSpec,
)
from repro_torch.core.compressed_store import decompress_weights

#: storage format of each parameter dtype (the reference's
#: ``spec_for_dtype`` over the NumPy dtypes its arrays carry)
SPEC_FOR_DTYPE = {
    torch.bfloat16: BF16,
    torch.float16: FP16,
    torch.float32: FP32,
    torch.float8_e4m3fn: FP8_E4M3,
    torch.float8_e5m2: FP8_E5M2,
    torch.int8: INT8,
    torch.uint8: INT8,
}

#: integer container a value's raw bits cross to the host in, per spec
_BITS = {8: (torch.uint8, np.uint8), 16: (torch.int16, np.uint16),
         32: (torch.int32, np.uint32)}


def spec_for_dtype(dtype: torch.dtype) -> FloatSpec:
    try:
        return SPEC_FOR_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"no FloatSpec for dtype {dtype}") from None


def host_bits(t: torch.Tensor, spec: FloatSpec) -> np.ndarray:
    """A tensor's values, flattened, as their raw bits (``spec.uint_np``)
    on the host: one device->host copy."""
    container, host = _BITS[spec.bits]
    flat = t.detach().reshape(-1)
    if flat.dtype != container:
        flat = flat.view(container)
    return flat.cpu().numpy().view(host)


@dataclasses.dataclass(frozen=True)
class _TensorEntry:
    key: str  # controller weight-store name ("L{layer}/{tensor-path}")
    name: str  # tensor path inside the layer handle ("attn/wq", ...)
    valid_values: int
    valid_logical_bytes: int
    stored_bytes: int


@dataclasses.dataclass
class LayerWeights:
    """One layer's compressed tensors — the unit the streamer fetches."""

    index: int
    entries: List[_TensorEntry]

    @property
    def valid_logical_bytes(self) -> int:
        return sum(e.valid_logical_bytes for e in self.entries)

    @property
    def stored_bytes(self) -> int:
        return sum(e.stored_bytes for e in self.entries)


class CompressedWeightStore:
    """Per-layer per-tensor block-compressed weights behind a controller.

    One store per memory tier: a sharded deployment passes ``part=(i, n)``
    so each tier ingests a contiguous 1/n slice of every flattened tensor
    (a tensor-parallel share — total bytes across tiers are conserved).
    """

    def __init__(self, controller):
        self.controller = controller
        self._layers: List[LayerWeights] = []

    # ---------------------------------------------------------------- ingest
    def ingest_layer(self, handle, part: tuple = (0, 1)) -> LayerWeights:
        """``handle``: one layer's (nested) dict of tensors, on any device."""
        from repro_torch.models.transformer import named_layer_tensors

        li = len(self._layers)
        vps = self.controller.config.values_per_segment
        entries = []
        for name, leaf in named_layer_tensors(handle):
            spec = spec_for_dtype(leaf.dtype)
            flat = host_bits(leaf, spec)
            if part[1] > 1:
                flat = np.array_split(flat, part[1])[part[0]]
            valid = int(flat.shape[0])
            if valid == 0:
                continue
            rem = (-valid) % vps
            if rem and self.controller.config.layout == "bitplane":
                flat = np.concatenate([flat, np.zeros(rem, flat.dtype)])
            key = f"L{li}/{name}"
            ct = self.controller.write_weights(key, flat, spec,
                                               valid_values=valid)
            entries.append(_TensorEntry(
                key=key,
                name=name,
                valid_values=valid,
                valid_logical_bytes=ct.valid_logical_bytes,
                stored_bytes=ct.stored_bytes,
            ))
        lw = LayerWeights(index=li, entries=entries)
        self._layers.append(lw)
        return lw

    @classmethod
    def from_handles(cls, handles, controller,
                     part: tuple = (0, 1)) -> "CompressedWeightStore":
        store = cls(controller)
        for h in handles:
            store.ingest_layer(h, part)
        return store

    # ---------------------------------------------------------------- access
    @property
    def n_layers(self) -> int:
        return len(self._layers)

    def layer(self, index: int) -> LayerWeights:
        return self._layers[index]

    @property
    def valid_logical_bytes(self) -> int:
        return sum(lw.valid_logical_bytes for lw in self._layers)

    @property
    def stored_bytes(self) -> int:
        return sum(lw.stored_bytes for lw in self._layers)

    @property
    def exact_savings(self) -> float:
        """Store-wide footprint reduction over exact (pad-free) bytes —
        the shared definition Table III quotes per-tensor."""
        vb = self.valid_logical_bytes
        return 1.0 - self.stored_bytes / vb if vb else 0.0

    def peek_layer(self, index: int) -> Dict[str, np.ndarray]:
        """Decompress one layer's tensors, trimmed to valid values, as
        their raw bits for bf16 and fp8 (test round-trips only: going
        through ``controller.read_weights`` would log weight_read events
        and corrupt the streamer's exactly-once accounting)."""
        out = {}
        for e in self._layers[index].entries:
            ct = self.controller.weight_tensor(e.key)
            out[e.name] = (
                decompress_weights(ct).reshape(-1)[: e.valid_values]
            )
        return out
