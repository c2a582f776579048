"""DeepSeekMoE-16B — 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066; hf].  Simplification vs. the HF checkpoint, as the
reference: the first layer is MoE here too (the official model has one
dense first layer)."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,  # MHA
    head_dim=128,
    d_ff=1408,  # per fine-grained expert
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    expert_shard="ep",  # 64 experts % 16 == 0: true expert parallelism
    pad_vocab_to=256,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab=512,
    n_experts=8,
    n_shared_experts=2,
    moe_top_k=3,
    expert_shard="ep",
)
