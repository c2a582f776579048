"""Mamba2 (SSD, state-space duality) block, chunked parallel form (port of
the reference's ``models/ssm.py``).

Within chunks of Q tokens the token mixing is the quadratic form masked by
the decay kernel; across chunks a linear recurrence carries the (H, N, P)
state.  Prefill and the training forward run the chunked scan through
:func:`repro_torch.kernels.ssd.ops.ssd` (the hand-written kernel on CUDA;
under autograd ``ops.SSDScan``, whose backward is the hand-written
``csrc/ssd_bwd.cu``); decode is the O(1) recurrent step in plain PyTorch,
as in the reference.

Projections are stored unfused (separate z/x/B/C/dt matrices), as in the
reference.  The rounding points are the reference's: products and the
convolution in the storage dtype (bf16), the scan, softplus and the gated
norm in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import gated_rmsnorm, he_init, rmsnorm_params


def ssm_params(generator: torch.Generator, cfg, dtype, d_model=None) -> dict:
    d = d_model or cfg.d_model
    h, p, n, g, w = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_groups, cfg.conv_width)
    din = h * p
    dev = generator.device
    # the reference draws a_log and dt_bias from default_rng(0) for every
    # layer, so every layer starts with the same decay rates and dt
    rng = np.random.default_rng(0)
    a_init = np.log(rng.uniform(1.0, 16.0, size=h)).astype(np.float32)
    dt0 = rng.uniform(1e-3, 1e-1, size=h)
    dt_bias = np.log(np.expm1(dt0)).astype(np.float32)
    return {
        "wz": he_init((d, din), generator, dtype),
        "wx": he_init((d, din), generator, dtype),
        "wb": he_init((d, g * n), generator, dtype),
        "wc": he_init((d, g * n), generator, dtype),
        "wdt": he_init((d, h), generator, dtype),
        "conv_x": he_init((w, din), generator, dtype, fan_in=w),
        "conv_b": he_init((w, g * n), generator, dtype, fan_in=w),
        "conv_c": he_init((w, g * n), generator, dtype, fan_in=w),
        "a_log": torch.from_numpy(a_init).to(dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.from_numpy(dt_bias).to(dev),
        "norm": rmsnorm_params(din, dtype, dev),
        "w_out": he_init((din, d), generator, dtype, fan_in=din),
    }


def _causal_conv(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, L, C); kernel: (W, C)."""
    w = kernel.shape[0]
    up = torch.nn.functional.pad(u, (0, 0, w - 1, 0))
    l = u.shape[1]
    out = up[:, 0:l, :] * kernel[0]
    for i in range(1, w):
        out = out + up[:, i:i + l, :] * kernel[i]
    return out


def _conv_step(u_t: torch.Tensor, tail: torch.Tensor, kernel: torch.Tensor):
    """One-token conv. u_t: (B, C); tail: (B, W-1, C) previous inputs.
    The W products are summed in float32 and rounded once, as the
    reference's bf16 einsum does."""
    window = torch.cat([tail, u_t[:, None, :]], dim=1)  # (B, W, C)
    out = (window.float() * kernel.float()).sum(dim=1).to(u_t.dtype)
    return out, window[:, 1:, :]


def _groups_to_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, ..., G, N) -> (B, ..., H, N) by contiguous block mapping."""
    return torch.repeat_interleave(t, h // t.shape[-2], dim=-2)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """silu as the reference's XLA expands it for bf16: x * 1/(1 + exp(-x)),
    each op rounded to the storage dtype (F.silu rounds only once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)) (no threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssd_scan(xdt, da, b, c, h0=None, chunk: int = 256):
    """Chunked SSD core: xdt (B, L, H, P) inputs pre-multiplied by dt; da
    (B, L, H) raw per-position dt·A (negative; the cumsum happens per chunk
    inside); b/c (B, L, G, N) per group, G dividing H (head h reads group
    h // (H / G); the reference passes them expanded to heads, which is
    G = H); all float32.  Returns (y (B, L, H, P), h_final (B, H, N, P))
    float32.  Runs the SSD kernel on CUDA tensors, differentiably (its
    backward kernel under autograd)."""
    return ssd_ops.ssd(xdt, da, b, c, h0=h0, chunk=chunk)


def ssm_apply(params: dict, x: torch.Tensor, cfg, initial=None):
    """Full Mamba2 block over a sequence. x: (B, L, d).

    Returns (y (B, L, d), cache) where cache = {'state', 'conv_x/b/c'} for
    continuing in decode mode."""
    h, p, w = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    bsz, l, _ = x.shape
    z = x @ params["wz"]
    xr = x @ params["wx"]
    br = x @ params["wb"]
    cr = x @ params["wc"]
    dt_raw = (x @ params["wdt"]).float()

    if initial is not None:
        xr_c = torch.cat([initial["conv_x"].to(xr.dtype), xr], dim=1)
        br_c = torch.cat([initial["conv_b"].to(br.dtype), br], dim=1)
        cr_c = torch.cat([initial["conv_c"].to(cr.dtype), cr], dim=1)
        xc = _causal_conv(xr_c, params["conv_x"])[:, w - 1:, :]
        bc = _causal_conv(br_c, params["conv_b"])[:, w - 1:, :]
        cc = _causal_conv(cr_c, params["conv_c"])[:, w - 1:, :]
    else:
        xc = _causal_conv(xr, params["conv_x"])
        bc = _causal_conv(br, params["conv_b"])
        cc = _causal_conv(cr, params["conv_c"])
    xc, bc, cc = _silu(xc), _silu(bc), _silu(cc)

    dt = _softplus(dt_raw + params["dt_bias"][None, None, :])  # (B, L, H)
    a = -torch.exp(params["a_log"])  # (H,)
    da = dt * a[None, None, :]

    xh = xc.reshape(bsz, l, h, p).float()
    bg = bc.reshape(bsz, l, cfg.ssm_groups, cfg.ssm_state).float()
    cg = cc.reshape(bsz, l, cfg.ssm_groups, cfg.ssm_state).float()
    xdt = xh * dt[..., None]
    h0 = initial["state"] if initial is not None else None
    y, h_final = ssd_scan(xdt, da, bg, cg, h0=h0, chunk=cfg.ssm_chunk)
    y = y + params["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, l, h * p).to(x.dtype)

    y = gated_rmsnorm(y, z, params["norm"], cfg.norm_eps)
    out = y @ params["w_out"]
    cache = {
        "state": h_final,
        "conv_x": _pad_tail(xr, w - 1, initial, "conv_x"),
        "conv_b": _pad_tail(br, w - 1, initial, "conv_b"),
        "conv_c": _pad_tail(cr, w - 1, initial, "conv_c"),
    }
    return out, cache


def _pad_tail(u: torch.Tensor, tail_len: int, initial, key: str) -> torch.Tensor:
    """The last ``tail_len`` conv inputs, reaching back into ``initial``
    (or zeros) when the sequence is shorter than the tail."""
    if u.shape[1] >= tail_len:
        return u[:, u.shape[1] - tail_len:, :]
    prev = (initial[key] if initial is not None
            else torch.zeros((u.shape[0], tail_len, u.shape[2]), dtype=u.dtype,
                             device=u.device))
    return torch.cat([prev, u], dim=1)[:, -tail_len:, :]


def ssm_decode_step(params: dict, x_t: torch.Tensor, cache: dict, cfg):
    """One-token recurrent step. x_t: (B, d); cache from ssm_apply/init.

    Returns (y_t (B, d), new cache)."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    bsz = x_t.shape[0]
    z = x_t @ params["wz"]
    xr = x_t @ params["wx"]
    br = x_t @ params["wb"]
    cr = x_t @ params["wc"]
    dt_raw = (x_t @ params["wdt"]).float()

    xc, conv_x = _conv_step(xr, cache["conv_x"].to(xr.dtype), params["conv_x"])
    bc, conv_b = _conv_step(br, cache["conv_b"].to(br.dtype), params["conv_b"])
    cc, conv_c = _conv_step(cr, cache["conv_c"].to(cr.dtype), params["conv_c"])
    xc, bc, cc = _silu(xc), _silu(bc), _silu(cc)

    dt = _softplus(dt_raw + params["dt_bias"][None, :])  # (B, H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a[None, :])  # (B, H)

    xh = xc.reshape(bsz, h, p).float()
    bh = _groups_to_heads(bc.reshape(bsz, cfg.ssm_groups, n).float(), h)
    ch = _groups_to_heads(cc.reshape(bsz, cfg.ssm_groups, n).float(), h)
    xdt = xh * dt[..., None]  # (B, H, P)
    state = cache["state"] * decay[:, :, None, None] + bh[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ch, state)  # (B, H, P)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, h * p).to(x_t.dtype)
    y = gated_rmsnorm(y[:, None, :], z[:, None, :], params["norm"], cfg.norm_eps)[:, 0]
    out = y @ params["w_out"]
    return out, {"state": state, "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c}


def ssm_init_cache(cfg, batch: int, device, dtype=torch.bfloat16) -> dict:
    h, p, n, w, g = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.conv_width, cfg.ssm_groups)
    din = h * p
    return {
        "state": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w - 1, din), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, w - 1, g * n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, w - 1, g * n), dtype=dtype, device=device),
    }
