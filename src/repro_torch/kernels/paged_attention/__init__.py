from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    batched_ladder_paged_attention,
    merge_rung_partials,
    pack_kv_planes,
    paged_attention_fused,
    paged_attention_rung,
    unpack_kv,
)
