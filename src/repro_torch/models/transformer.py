"""Decoder-only dense LM (port of the reference's ``models/transformer.py``:
the serving entry points).

Parameters are a nested dict in the reference's layout — layer tensors
stacked on axis 0 — so weights carry across bit-exactly
(:mod:`repro_torch.models.convert`).  A Python loop over layers replaces
``lax.scan``.

Caches: dense ``{'k','v': (L, B, S, Hkv, hd) bf16, 'len'}`` or bit-plane
``{'k_planes','v_planes': (L, bits, B, S, Hkv, hd//8) uint8, 'planes':
(B, S/16) int32, 'len'}``.  Where the reference returns a new cache, these
functions write the same rows into the given cache tensors in place and
return the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import pack_kv_planes
from repro_torch.models.attention import attn_apply, attn_params
from repro_torch.models.layers import (
    embed_apply,
    embed_params,
    he_init,
    layer_slice,
    mlp_apply,
    pdtype,
    rmsnorm,
    rmsnorm_params,
    stack_layers,
)


def block_params(generator: torch.Generator, cfg, dtype) -> dict:
    """One pre-norm block's weights {ln1, attn, ln2, mlp (SwiGLU)}."""
    d, ff, dev = cfg.d_model, cfg.d_ff, generator.device
    return {
        "ln1": rmsnorm_params(d, dtype, dev),
        "attn": attn_params(generator, cfg, dtype),
        "ln2": rmsnorm_params(d, dtype, dev),
        "mlp": {
            "w_gate": he_init((d, ff), generator, dtype),
            "w_in": he_init((d, ff), generator, dtype),
            "w_out": he_init((ff, d), generator, dtype, fan_in=ff),
        },
    }


def init_lm_params(cfg, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn from ``generator``
    (on the device the parameters should live on)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the dense slice only)")
    dtype = pdtype(cfg)
    d = cfg.d_model
    embed = embed_params(generator, cfg.vocab_padded, d, dtype)
    layers = [block_params(generator, cfg, dtype) for _ in range(cfg.n_layers)]
    params = {"embed": embed, "layers": stack_layers(layers),
              "final_norm": rmsnorm_params(d, dtype, generator.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": he_init((cfg.vocab_padded, d), generator, dtype)}
    return params


def head_weight(params: dict) -> torch.Tensor:
    return params.get("lm_head", {"w": params["embed"]["table"]})["w"]


def block_apply(lp, x, cfg, *, pos, cache=None, cache_len=None, kv_planes=None,
                keeps=None, decode_kernel="fused"):
    """One pre-norm transformer block {ln1, attn, ln2, mlp} over x (B, S, d)
    (the dense family's layer and Zamba2's shared block).  The cache
    arguments are :func:`attn_apply`'s.  Returns (x, new_kv): new_kv is
    the projected (k, v) when ``cache`` is None."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, new_kv = attn_apply(lp["attn"], h, cfg, pos=pos, cache=cache,
                                  cache_len=cache_len, kv_planes=kv_planes,
                                  keeps=keeps, decode_kernel=decode_kernel)
    # the reference's compiled layer fuses this residual add into the norm
    # after it and keeps the sum in float32 there; the residual stream
    # itself is stored rounded
    h2 = rmsnorm(x.float() + attn_out.float(), lp["ln2"], cfg.norm_eps).to(x.dtype)
    x = x + attn_out
    return x + mlp_apply(lp["mlp"], h2, cfg.act), new_kv


def run_stack(params, cfg, x, pos, cache=None, keeps=None, decode_kernel="fused"):
    """x: (B, S, d); pos: (B, S).  cache: None (plain causal forward) or a
    serving cache dict (dense or bit-plane, see the module docstring) whose
    rows are appended in place.  ``keeps``/``decode_kernel`` steer bit-plane
    decode.  Returns the final hidden states (B, S, d)."""
    cache_len = None if cache is None else cache["len"]
    bitplane = cache is not None and "k_planes" in cache
    kn, vn = ("k_planes", "v_planes") if bitplane else ("k", "v")
    kv_planes = cache.get("planes") if bitplane else None
    for i in range(cfg.n_layers):
        kv = None if cache is None else (cache[kn][i], cache[vn][i])
        x, _ = block_apply(layer_slice(params["layers"], i), x, cfg, pos=pos,
                           cache=kv, cache_len=cache_len, kv_planes=kv_planes,
                           keeps=keeps, decode_kernel=decode_kernel)
    return x


def _logits(params, cfg, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ head_weight(params).T).float()


def lm_prefill_chunk(params, cfg, tokens, cache, slot: int, start: int,
                     last_idx: int):
    """Bucketed chunked prefill: append one prompt chunk into one slot's
    rows of the serving batch cache.

    tokens: (1, C) int — a power-of-two bucket; a ragged final chunk is
    right-padded (its pad sits after every real token, so causality keeps
    it out of every real row).  Rows [start, start + C) of ``slot`` are
    written in place; the chunk attends to the slot's rows [0, start).
    Returns (logits (1, Vpad) float32 at chunk index ``last_idx``, cache).
    """
    bitplane = "k_planes" in cache
    kn, vn, slot_ax = ("k_planes", "v_planes", 2) if bitplane else ("k", "v", 1)
    sub = {kn: cache[kn].narrow(slot_ax, slot, 1),
           vn: cache[vn].narrow(slot_ax, slot, 1), "len": int(start)}
    x = embed_apply(params["embed"], tokens)
    c = x.shape[1]
    pos = start + torch.arange(c, dtype=torch.int32, device=x.device)[None]
    x = run_stack(params, cfg, x, pos, cache=sub)
    logits = _logits(params, cfg, x[:, last_idx:last_idx + 1])[:, 0]
    return logits, cache


def lm_decode(params, cfg, token, cache, keeps=None, decode_kernel="fused"):
    """token: (B,) int; cache['len']: (B,) per-row lengths (continuous
    batching: each slot decodes at its own position against its own valid
    prefix).  Bit-plane caches take ``keeps`` — the plane counts the ladder
    can assign — and run decode attention through the paged-attention
    kernel (``decode_kernel``: "fused" = one launch per layer, "rung" = one
    launch per member of ``keeps``).  Returns (logits (B, Vpad) float32,
    cache) with the new token's rows written in place."""
    x = embed_apply(params["embed"], token[:, None])
    ln = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    pos = ln[:, None]
    x = run_stack(params, cfg, x, pos, cache=cache, keeps=keeps,
                  decode_kernel=decode_kernel)
    logits = _logits(params, cfg, x)[:, 0]
    cache["len"] = ln + 1
    return logits, cache


def init_decode_cache(cfg, batch: int, max_len: int, device,
                      dtype=None) -> dict:
    """Zeroed dense serving cache (full attention only)."""
    if 0 < cfg.attn_window < max_len or cfg.decode_staging > 0:
        raise NotImplementedError(
            "ring and staged decode caches are not ported yet: they come with "
            "the 'ring and sharded backends' and 'rest of serving' slices "
            "(ROADMAP queue 1)")
    dtype = dtype or pdtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def bitplane_cache_from_dense(cache: dict, page_tokens: int = 16,
                              bits: int = 16) -> dict:
    """Convert a dense serving cache into the bit-plane device layout:
    {'k_planes','v_planes'} (L, bits, B, S, Hkv, hd//8) uint8 plus a
    per-device-page 'planes' map (B, S/page_tokens) int32 at full
    precision.  Packing is a bf16 bitcast, so a populated cache round-trips
    bit-exactly at keep == bits.  Packs one layer at a time to bound the
    temporary."""
    l, b, s, hkv, hd = cache["k"].shape
    if hd % 8 != 0:
        raise ValueError(f"bit-plane packing needs head_dim % 8 == 0, got {hd}")
    out = {k: v for k, v in cache.items() if k not in ("k", "v")}
    for name in ("k", "v"):
        planes = torch.empty((l, bits, b, s, hkv, hd // 8), dtype=torch.uint8,
                             device=cache[name].device)
        for i in range(l):
            planes[i] = pack_kv_planes(cache[name][i], bits)
        out[name + "_planes"] = planes
    n_pages = -(-s // page_tokens)
    out["planes"] = torch.full((b, n_pages), bits, dtype=torch.int32,
                               device=cache["k"].device)
    return out
