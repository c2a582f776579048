"""Whisper-tiny — encoder-decoder [arXiv:2212.04356].  The conv audio
frontend is a stub, as in the reference: the encoder takes precomputed
frame embeddings at ``d_model`` (``models.frontends``).  39M params:
weights replicated (DP-only)."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    replicate_weights=True,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    act="gelu",
)
