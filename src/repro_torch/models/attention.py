"""GQA attention for the dense transformer (port of the reference's
``models/attention.py``: the parts the serving main path runs).

* q-heads may be padded (``cfg.pad_heads_to``); padded heads have zero
  ``wq`` rows and are masked before ``wo``.  Each q head reads kv head
  ``h // rep_p``, ``rep_p = Hp / Hkv`` (grouped layout).
* Prefill attention is the flash-attention forward
  (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`): the
  hand-written kernel on CUDA, its plain PyTorch version on the CPU (the
  reference runs a jnp online softmax here, whose TPU form is its Pallas
  flash kernel).  A one-token step over a dense cache runs
  :func:`decode_attention`, as in the reference.
* A serving cache is either dense bf16 rows ``(k, v)`` or packed uint8
  bit-planes ``(k_planes, v_planes)`` of layout (bits, B, S, Hkv, hd//8).
  Bit-plane decode packs the new token and runs the paged-attention
  kernel, which reads only the planes the per-page plane map prescribes;
  a prefill chunk attends densely at full precision and packs its rows.

The reference rebuilds the cache functionally on every step; here the
cache tensors are updated in place (each place says so), since a per-layer
cache is a view into the stacked serving cache.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.bitplane import ops as bitplane_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention.ops import batched_ladder_paged_attention
from repro_torch.models.layers import apply_rope, he_init, rope_angles

NEG_INF = -1e30


def valid_q_heads(n_q_heads_padded, n_heads, n_kv_heads) -> np.ndarray:
    """(Hp,) bool — which padded q-head slots are real heads."""
    hkv = max(1, n_kv_heads)
    rep_p = n_q_heads_padded // hkv
    rep = max(1, n_heads) // hkv
    return (np.arange(n_q_heads_padded) % rep_p) < rep


def attn_params(generator, cfg, dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    hp, hkv, hd = cfg.n_q_heads_padded, cfg.n_kv_heads, cfg.head_dim
    valid = torch.as_tensor(valid_q_heads(hp, cfg.n_heads, hkv), dtype=dtype,
                            device=generator.device)
    wq = he_init((d, hp, hd), generator, dtype, fan_in=d) * valid[None, :, None]
    wk = he_init((d, hkv, hd), generator, dtype, fan_in=d)
    wv = he_init((d, hkv, hd), generator, dtype, fan_in=d)
    wo = he_init((hp, hd, d), generator, dtype, fan_in=hp * hd) * valid[:, None, None]
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _scale(hd: int, device) -> torch.Tensor:
    return torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32, device=device)


def decode_attention(q, k, v, *, q_pos, kv_valid):
    """Single-token causal attention over a dense cache (the reference's
    ``decode_attention``): q (B, 1, Hp, hd); k/v (B, Skv, Hkv, hd).  GQA is
    a reshape of q (grouped head layout); scores are float32."""
    b, sq, hp, hd = q.shape
    hkv = k.shape[2]
    rep = hp // hkv
    qf = q.reshape(b, hkv, rep, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs", qf, k.float()) * _scale(hd, q.device)
    kpos = torch.arange(k.shape[1], device=q.device)[None]
    kv_valid = torch.as_tensor(kv_valid, device=q.device)
    if kv_valid.dim() == 0:
        kv_valid = kv_valid.expand(b)
    ok = (kpos < kv_valid[:, None]) & (kpos <= q_pos[:, :1])
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrs,bskd->bkrd", p.to(q.dtype).float(), v.float())
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, hp, hd).to(q.dtype)


def _bitplane_cache_step(q, k, v, cache, *, pos, cache_len, kv_planes,
                         keeps, decode_kernel="fused"):
    """One step against a bit-plane packed device cache (reference
    ``_bitplane_cache_step``, without its ring branch).

    cache: (k_planes, v_planes) — per-layer views, (bits, B, S, Hkv, hd//8)
    uint8, updated IN PLACE.  kv_planes: (B, S/16) int32 per-page plane
    counts; keeps: the distinct plane counts kv_planes may hold.  Decode
    (one token) packs the token and runs the paged-attention kernel; a
    prefill chunk (c > 1) attends densely at full precision and packs its
    rows."""
    kp, vp = cache
    bits = kp.shape[0]
    c = k.shape[1]
    if c > 1:  # prefill chunk: full-precision dense attend, pack on adoption
        end = int(cache_len) + c
        if end > kp.shape[2]:
            raise ValueError(f"prefill chunk ends at {end} past the cache ({kp.shape[2]})")
        # the slot's whole S rows, as the reference: rows past `end` are
        # masked, but the attention sums then run over the same length
        kd, vd = bitplane_ops.unpack_kv_pair(kp, vp, bits, bits)
        kd[:, cache_len:end] = k.to(kd.dtype)
        vd[:, cache_len:end] = v.to(vd.dtype)
        out = flash_ops.flash_attention(q, kd, vd, q_pos=pos, kv_valid=end)
        # in place: the reference's dynamic_update_slice of the packed rows
        bitplane_ops.pack_kv_into(k, v, kp, vp, int(cache_len))
        return out
    # decode: pack-append the token at each row's own position (the
    # reference's kp.at[:, rows, clip(len, 0, S - 1)].set, in place), then
    # the partial-plane kernel (per-slot valid lengths and ladders).  Idle
    # rows append garbage at their own position, masked for every real query.
    ln = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if ln.dim() == 0:
        ln = ln.expand(kp.shape[1])
    bitplane_ops.pack_kv_into(k, v, kp, vp, ln)
    out = batched_ladder_paged_attention(
        q, kp, vp, kv_planes, ln + 1,
        keeps=tuple(keeps) if keeps is not None else (bits,),
        bits=bits, q_pos=pos, kernel=decode_kernel,
    )
    return out.to(q.dtype)


def attn_apply(params, x, cfg, *, pos, cache=None, cache_len=None,
               kv_planes=None, keeps=None, decode_kernel="fused"):
    """One attention sub-layer (reference ``attn_apply``: the ``cache=None``,
    dense per-row / prefill-append and bit-plane branches).

    x: (B, S, d); pos: (B, S) absolute positions.  cache: None (causal
    self-attention over x, the new (k, v) returned for building a cache),
    a dense (k, v) pair of (B, S_cache, Hkv, hd) rows, or a bit-plane
    (k_planes, v_planes) pair — either updated IN PLACE.  cache_len: int
    (prefill chunk appended at that offset) or (B,) per-row lengths
    (continuous-batching decode, one token per row).
    Returns (y, new_kv) — new_kv is the projected (k, v) when cache is None.
    """
    if cfg.attn_window > 0:
        raise NotImplementedError(
            "sliding-window attention (ring caches) is not ported yet: it "
            "comes with the 'ring and sharded backends' slice (ROADMAP queue 1)"
        )
    hp = params["wq"].shape[1]
    d = x.shape[-1]
    b, s = x.shape[0], x.shape[1]
    q = (x.reshape(b * s, d) @ params["wq"].reshape(d, -1)).reshape(b, s, hp, -1)
    k = (x.reshape(b * s, d) @ params["wk"].reshape(d, -1)).reshape(b, s, cfg.n_kv_heads, -1)
    v = (x.reshape(b * s, d) @ params["wv"].reshape(d, -1)).reshape(b, s, cfg.n_kv_heads, -1)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_kv = None
    if cache is None:
        out = flash_ops.flash_attention(q, k, v, q_pos=pos, kv_valid=pos[:, -1] + 1)
        new_kv = (k, v)
    elif cache[0].dtype == torch.uint8:
        out = _bitplane_cache_step(q, k, v, cache, pos=pos,
                                   cache_len=cache_len, kv_planes=kv_planes,
                                   keeps=keeps, decode_kernel=decode_kernel)
    elif torch.is_tensor(cache_len) and cache_len.dim() == 1:
        # continuous batching: each row appends its token at its own slot
        if s != 1:
            raise ValueError("per-row cache lengths are a decode-only path")
        ck, cv = cache
        rows = torch.arange(b, device=x.device)
        slot = torch.clamp(cache_len, 0, ck.shape[1] - 1).long()
        # in place: the reference's ck.at[rows, slot].set(k[:, 0])
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        out = decode_attention(q, ck, cv, q_pos=pos, kv_valid=cache_len + 1)
    else:
        ck, cv = cache
        end = int(cache_len) + s
        if end > ck.shape[1]:
            # the reference's dynamic_update_slice would clamp the write
            # to the last rows and go on silently
            raise ValueError(
                f"{s} token(s) at {int(cache_len)} overrun the cache of "
                f"{ck.shape[1]} rows; pad it first (prepare_decode_cache)")
        # in place: the reference's dynamic_update_slice at cache_len
        ck[:, cache_len:end] = k.to(ck.dtype)
        cv[:, cache_len:end] = v.to(cv.dtype)
        # over the whole cache, rows past `end` masked, as the reference
        if s == 1:
            out = decode_attention(q, ck, cv, q_pos=pos, kv_valid=end)
        else:
            out = flash_ops.flash_attention(q, ck, cv, q_pos=pos, kv_valid=end)

    if hp != cfg.n_heads:  # mask padded heads
        valid = torch.as_tensor(valid_q_heads(hp, cfg.n_heads, cfg.n_kv_heads),
                                dtype=out.dtype, device=out.device)
        out = out * valid[None, None, :, None]
    y = out.reshape(b * s, -1) @ params["wo"].reshape(-1, d)
    return y.reshape(b, s, d), new_kv
