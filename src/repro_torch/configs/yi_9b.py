"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652; hf]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=8,
    n_kv_heads=2,
    head_dim=12,
    d_ff=192,
    vocab=384,
    rope_theta=5_000_000.0,
)
