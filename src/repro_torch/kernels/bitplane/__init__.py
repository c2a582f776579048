from repro_torch.kernels.bitplane.ops import (  # noqa: F401
    pack,
    pack_raw,
    unpack,
    unpack_raw,
)
