"""SmolLM-135M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    rope_theta=10_000.0,
    # 135M params: 16-way TP is counterproductive; DP-only (weights replicated)
    replicate_weights=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    tie_embeddings=True,
)
