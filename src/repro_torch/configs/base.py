"""Config system: the reference's ``ModelConfig``, copied field for field.

An architecture registers a FULL config (the exact published shape) and a
SMOKE config (same family, reduced depth/width, runnable on CPU in
seconds).  The port serves the dense transformer family (``smollm-135m``),
the SSM family (``mamba2-1.3b``) and the hybrid family (``zamba2-7b``);
the other architectures of the reference raise until the slice that ports
their family lands.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    act: str = "swiglu"  # swiglu | relu2 | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    attn_window: int = 0  # 0 = full causal; >0 = sliding-window
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    expert_shard: str = "tp"  # 'ep' (experts over model axis) | 'tp' (d_ff)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Zamba2): every `attn_period`-th slot is the shared block ---
    attn_period: int = 0
    # --- VLM ---
    n_patches: int = 0  # image tokens prepended to the text sequence
    # --- enc-dec (Whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- distribution ---
    pad_heads_to: int = 0  # pad q-heads to a multiple (exactness-preserving)
    pad_vocab_to: int = 1  # pad vocab to a multiple (masked in the loss)
    #: staged decode cache (§Perf Cell-3): >0 = staging-ring slots; the big
    #: cache is read-only per step, flushed every `decode_staging` steps
    decode_staging: int = 0
    replicate_weights: bool = False  # tiny models: batch-parallel only
    remat: bool = True
    dtype: str = "bfloat16"
    # which shape cells this arch runs
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")

    # ------------------------------------------------------------------
    @property
    def n_q_heads_padded(self) -> int:
        if self.pad_heads_to <= 0:
            return self.n_heads
        m = self.pad_heads_to
        return -(-self.n_heads // m) * m

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m

    @property
    def gqa_rep(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def d_inner(self) -> int:
        """SSD inner width."""
        return self.ssm_heads * self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (drives roofline MODEL_FLOPS)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.act == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        norms = 2 * d

        def dense_layer():
            return attn + mlp + norms

        def moe_layer():
            experts = self.n_experts * (3 * d * ff)
            shared = self.n_shared_experts * (3 * d * ff)
            router = d * self.n_experts
            return attn + experts + shared + router + norms

        def ssm_layer():
            din = self.d_inner
            gn = self.ssm_groups * self.ssm_state
            in_proj = d * (2 * din + 2 * gn + self.ssm_heads)
            conv = (din + 2 * gn) * self.conv_width
            out = din * d
            return in_proj + conv + out + norms

        if self.family in ("dense", "vlm"):
            body = self.n_layers * dense_layer()
        elif self.family == "moe":
            body = self.n_layers * moe_layer()
        elif self.family == "ssm":
            body = self.n_layers * ssm_layer()
        elif self.family == "hybrid":
            n_attn = self.n_attn_slots
            body = (self.n_layers - n_attn) * ssm_layer() + dense_layer()
        elif self.family == "encdec":
            # encoder + decoder(with cross-attn)
            body = self.n_enc_layers * dense_layer() + self.n_layers * (
                dense_layer() + attn + d
            )
        else:
            raise ValueError(self.family)
        embed = v * d
        head = 0 if self.tie_embeddings else v * d
        return body + embed + head

    @property
    def n_attn_slots(self) -> int:
        if self.family != "hybrid" or self.attn_period <= 0:
            return 0
        return self.n_layers // self.attn_period

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        per_expert = 3 * d * ff
        inactive = (self.n_experts - self.moe_top_k) * per_expert * self.n_layers
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

#: architectures the reference registers that the port does not serve yet
_LATER = (
    "yi-34b", "nemotron-4-15b", "yi-9b", "deepseek-moe-16b", "mixtral-8x7b",
    "llava-next-34b", "whisper-tiny",
)

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _LATER:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: the port serves the dense family "
            f"(smollm-135m), the SSM family (mamba2-1.3b) and the hybrid "
            f"family (zamba2-7b); other configs "
            f"and families come with the 'other model families' slice "
            f"(ROADMAP queue 1)"
        )
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.FULL
