"""Mamba2-1.3B — SSD (state-space duality), attention-free
[arXiv:2405.21060].  d_inner = 2*d_model, 64 heads of dim 64, state 128,
ngroups=1 (official); B/C projections are replicated under TP (small), heads
are sharded."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=512,
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_groups=1,
    conv_width=4,
    ssm_chunk=32,
    tie_embeddings=True,
)
