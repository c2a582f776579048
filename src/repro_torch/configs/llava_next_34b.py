"""LLaVA-NeXT-34B — Yi-34B backbone + anyres vision tiling
[hf:llava-hf].  The vision tower is a stub, as in the reference: the model
takes precomputed patch embeddings (n_patches, VISION_DIM), which it
projects and prepends to the text sequence (``models.frontends``)."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
    n_patches=2880,  # anyres: 5 tiles x 576 patches
    pad_heads_to=16,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    n_patches=16,
)
