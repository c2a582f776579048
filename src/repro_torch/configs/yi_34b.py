"""Yi-34B — llama-arch dense GQA [arXiv:2403.04652; hf]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
    pad_heads_to=16,  # 56 -> 64 q heads for 16-way TP (exactness-preserving)
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),  # full attention: no 500k
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    rope_theta=5_000_000.0,
)
