from repro_torch.kernels.bitplane.ops import (  # noqa: F401
    pack,
    pack_kv_into,
    pack_raw,
    unpack,
    unpack_kv_pair,
    unpack_raw,
)
