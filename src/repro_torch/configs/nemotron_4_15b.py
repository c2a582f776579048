"""Nemotron-4-15B — GQA, squared-ReLU non-gated MLP [arXiv:2402.16819]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    act="relu2",
    rope_theta=10_000.0,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=512,
    vocab=1024,
    act="relu2",
)
