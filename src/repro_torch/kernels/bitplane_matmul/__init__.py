from repro_torch.kernels.bitplane_matmul.ops import (  # noqa: F401
    bitplane_matmul,
    pack_weights,
    weight_fetch_bytes,
)
