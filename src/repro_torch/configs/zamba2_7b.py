"""Zamba2-7B — Mamba2 backbone + shared attention block every 6th slot
[arXiv:2411.15242].  Simplifications vs. official (noted in DESIGN.md §8):
single shared transformer block without per-invocation LoRA."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,  # slots; every 6th is the shared attention block (13 total)
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,  # MHA in the shared block
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_heads=112,
    ssm_head_dim=64,
    ssm_groups=2,
    conv_width=4,
    attn_period=6,
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="hybrid",
    n_layers=7,  # slots 5 is shared-attn (period 6) + 1 tail mamba
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_groups=2,
    conv_width=4,
    ssm_chunk=32,
    attn_period=6,
)
