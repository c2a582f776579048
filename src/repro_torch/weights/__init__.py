"""Weight streaming: block-compressed layer weights served through the
memory controller (a copy of the reference's ``weights`` package; paper
Table III quotes the 25.2% weight footprint reduction this subsystem
carries into the serving path).

``CompressedWeightStore`` holds each transformer layer's tensors
block-compressed (bit-plane + lz4/zstd, blocks sized to the lane engine's
stripe granularity); ``WeightStreamer`` double-buffers the next layer
pass's decompress jobs through the memctl lane engine while the current
pass's matmuls run, contending for the same lane budget as KV fetches
(``JobClass.WEIGHT_FETCH``).
"""

from repro_torch.weights.store import CompressedWeightStore, LayerWeights
from repro_torch.weights.streamer import WeightStreamer

__all__ = ["CompressedWeightStore", "LayerWeights", "WeightStreamer"]
