"""Shared primitives: norms (plain and Mamba2's gated one), rotary and
sinusoidal position embeddings, the MLPs (SwiGLU, squared ReLU, tanh
GELU), embeddings.

Plain functions over parameter dicts, in the reference's layouts.  The
rounding points are the reference's (``models/layers.py``): float32 inside
``rmsnorm`` and ``apply_rope`` with a cast back to the storage dtype after,
and products in the storage dtype (bf16) elsewhere.
"""

from __future__ import annotations

import math

import torch


def pdtype(cfg) -> torch.dtype:
    """The parameters' storage dtype (``cfg.dtype``, bf16 by default)."""
    return getattr(torch, cfg.dtype)


def he_init(shape, generator: torch.Generator, dtype=torch.bfloat16,
            fan_in: int | None = None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def rmsnorm_params(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, params: dict,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(z)), the gate applied before the
    normalisation, all in float32 (``x * sigmoid(x)`` is the float32 silu
    closest to XLA's: it differs in the last bit on under 1% of inputs)."""
    zf = z.float()
    xf = x.float() * (zf * torch.sigmoid(zf))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim//2) float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd//2) broadcast over H."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, (seq_len, d_model)
    float32: [sin, cos] of position x exp(-i log(10000) / (half - 1))."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)[:, None]
    half = d_model // 2
    rate = torch.tensor(math.log(10000.0) / max(1, half - 1), dtype=torch.float32,
                        device=device)
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=device) * rate)
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp_params(generator: torch.Generator, d: int, d_ff: int, act: str,
               dtype=torch.bfloat16) -> dict:
    """SwiGLU {w_gate, w_in, w_out}, or the non-gated {w_in, w_out} of the
    squared-ReLU and GELU MLPs, drawn in that order."""
    gate = {"w_gate": he_init((d, d_ff), generator, dtype)} if act == "swiglu" else {}
    return {**gate,
            "w_in": he_init((d, d_ff), generator, dtype),
            "w_out": he_init((d_ff, d), generator, dtype, fan_in=d_ff)}


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) as XLA evaluates it in bf16: every
    operation of x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))
    rounded to the storage dtype, the constants too (bit for bit with the
    reference over every normal bf16 input; ``F.gelu`` rounds only once)."""
    dt = h.dtype

    def const(c):
        return torch.tensor(c, dtype=torch.float32, device=h.device).to(dt)

    inner = h + const(0.044715) * (h * h * h)
    cdf = 0.5 * (1.0 + torch.tanh(const(math.sqrt(2 / math.pi)) * inner))
    return h * cdf


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = x @ params["w_gate"]
        # silu as the reference's XLA expands it for bf16: x * 1/(1 + exp(-x)),
        # each op rounded to the storage dtype (F.silu rounds only once)
        h = g * (1 / (1 + torch.exp(-g))) * (x @ params["w_in"])
    elif act == "relu2":  # Nemotron: squared ReLU, non-gated
        h = torch.square(torch.relu(x @ params["w_in"]))
    elif act == "gelu":
        h = gelu_tanh(x @ params["w_in"])
    else:
        raise ValueError(act)
    return h @ params["w_out"]


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree whose tensors are stacked on a leading layer
    axis (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def stack_layers(trees: list) -> dict:
    """Per-layer trees of one shape -> one tree stacked on a leading layer
    axis (the reference's ``vmap``/``scan`` layout)."""
    return {k: stack_layers([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def stack_layers_from(make, n: int) -> dict:
    """``stack_layers([make() for _ in range(n)])`` without the second copy:
    the stacked tensors are allocated from the first layer's tree and each
    layer is written into them as it is made (a full-width model's layers
    fill most of the card once, not twice).  The layers are made in order,
    so generator draws are those of the list form."""
    first = make()

    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty((n,) + tuple(t.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
    return out


def empty_layers(one: dict) -> dict:
    """A tree shaped like one layer's, stacked on a leading layer axis of
    length 0 (the reference's scan over no layers)."""
    return {k: empty_layers(v) if isinstance(v, dict) else v.new_zeros((0,) + tuple(v.shape))
            for k, v in one.items()}


def embed_params(generator: torch.Generator, vocab_padded: int, d: int,
                 dtype=torch.bfloat16) -> dict:
    return {"table": he_init((vocab_padded, d), generator, dtype, fan_in=d)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]
