"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].  The window (4096) bounds the decode KV cache: the
serving stack holds it in a per-slot ring (``backend="ring"``)."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    n_shared_experts=0,
    moe_top_k=2,
    expert_shard="tp",  # 8 experts < 16-way model axis: shard expert d_ff
    attn_window=4096,
    rope_theta=1_000_000.0,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    n_experts=4,
    moe_top_k=2,
    expert_shard="tp",
    attn_window=64,
)
