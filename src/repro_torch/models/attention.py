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
* A sliding-window config (``cfg.attn_window`` > 0, Mixtral) serves from
  a ring cache: the sequence axis holds ``window`` slots, a token at
  absolute position p lands in slot ``p % window``, and a ``pos`` plane
  (B, window) records each slot's absolute position (-1 = unfilled).  A
  prefill chunk attends over [the ring's old entries] ++ [the chunk] with
  every key at its own position (the flash kernel's ``kv_pos``); decode
  folds the positions and the window into the paged kernels' mask.

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


def mask_padded_heads(out: torch.Tensor, cfg) -> torch.Tensor:
    """The attention output (B, S, Hp, hd) with its padded q heads set to
    zero before ``wo`` (a padded head's zero query attends uniformly, so
    its raw output is the mean of the values, not zero)."""
    hp = out.shape[2]
    if hp == cfg.n_heads:
        return out
    valid = torch.as_tensor(valid_q_heads(hp, cfg.n_heads, cfg.n_kv_heads),
                            dtype=out.dtype, device=out.device)
    return out * valid[None, None, :, None]


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


def decode_attention(q, k, v, *, q_pos, kv_valid, window=0, kv_pos=None,
                     bidirectional=False):
    """Single-token attention over a dense cache (the reference's
    ``decode_attention``): q (B, 1, Hp, hd); k/v (B, Skv, Hkv, hd); kv_pos
    (B, Skv) the slots' absolute positions of a ring cache (-1 =
    unfilled), else their indices; keys at positions >= kv_valid are
    masked, and so are keys after q_pos unless ``bidirectional`` (an
    enc-dec model's cross attention over the encoder's frames); ``window``
    > 0 masks keys at or before q_pos - window.  GQA is a reshape of q
    (grouped head layout); scores are float32."""
    b, sq, hp, hd = q.shape
    hkv = k.shape[2]
    rep = hp // hkv
    qf = q.reshape(b, hkv, rep, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs", qf, k.float()) * _scale(hd, q.device)
    kpos = (torch.arange(k.shape[1], device=q.device)[None] if kv_pos is None
            else kv_pos)
    kv_valid = torch.as_tensor(kv_valid, device=q.device)
    if kv_valid.dim() == 0:
        kv_valid = kv_valid.expand(b)
    ok = (kpos >= 0) & (kpos < kv_valid[:, None])
    if not bidirectional:
        ok = ok & (kpos <= q_pos[:, :1])
    if window > 0:
        ok = ok & (kpos > q_pos[:, :1] - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrs,bskd->bkrd", p.to(q.dtype).float(), v.float())
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, 1, hp, hd).to(q.dtype)


def _ring_chunk_append(q, k, v, ck, cv, cpos, *, pos, cache_len: int,
                       append_valid, window: int):
    """Ring chunk append (reference ``_ring_chunk_append``): a bucketed
    prefill chunk of c <= window tokens into a one-row sliding-window ring.
    The chunk attends over [the ring's old entries] ++ [the chunk itself],
    each key at its absolute position: a slot the chunk is about to
    overwrite is still visible at its OLD position to the chunk's early
    queries, and a slot's old position p and its new occupant p + window
    never both pass the window mask for one query.  Then the REAL tokens
    (positions < ``append_valid``, the chunk's end when None) are written
    into their slots ``p % window`` of ck, cv and cpos, IN PLACE: a
    right-padded ragged tail must not clobber older in-window entries."""
    w, c = ck.shape[1], k.shape[1]
    idx = int(cache_len) + torch.arange(c, device=q.device)
    valid_end = int(cache_len) + c if append_valid is None else int(append_valid)
    out = flash_ops.flash_attention(
        q, torch.cat([ck, k.to(ck.dtype)], dim=1), torch.cat([cv, v.to(cv.dtype)], dim=1),
        q_pos=pos, kv_valid=valid_end, window=window,
        kv_pos=torch.cat([cpos, pos.to(cpos.dtype)], dim=1))
    keep = idx < valid_end
    slots = idx[keep] % w
    ck[:, slots] = k[:, keep].to(ck.dtype)
    cv[:, slots] = v[:, keep].to(cv.dtype)
    cpos[:, slots] = pos[:, keep].to(cpos.dtype)
    return out


def _bitplane_cache_step(q, k, v, cache, *, pos, cache_len, kv_planes,
                         keeps, window=0, append_valid=None,
                         decode_kernel="fused"):
    """One step against a bit-plane packed device cache (reference
    ``_bitplane_cache_step``).

    cache: (k_planes, v_planes[, kv_pos]) — per-layer views, planes (bits,
    B, S, Hkv, hd//8) uint8 and a ring's (B, S) int32 positions, updated
    IN PLACE.  kv_planes: (B, S/16) int32 per-page plane counts; keeps:
    the distinct plane counts kv_planes may hold.  Decode (one token) packs
    the token and runs the paged-attention kernel; a prefill chunk (c > 1)
    attends densely at full precision and packs its rows (a ring chunk:
    one unpack of the window, the ring append, one pack of the whole
    window, since the chunk's slots are scattered)."""
    ring = len(cache) == 3
    kp, vp = cache[0], cache[1]
    cpos = cache[2] if ring else None
    bits = kp.shape[0]
    c = k.shape[1]
    if c > 1 and ring:
        kd, vd = bitplane_ops.unpack_kv_pair(kp, vp, bits, bits)
        out = _ring_chunk_append(q, k, v, kd, vd, cpos, pos=pos, cache_len=cache_len,
                                 append_valid=append_valid, window=window)
        bitplane_ops.pack_kv_into(kd, vd, kp, vp, 0)
        return out
    if c > 1:  # prefill chunk: full-precision dense attend, pack on adoption
        end = int(cache_len) + c
        if end > kp.shape[2]:
            raise ValueError(f"prefill chunk ends at {end} past the cache ({kp.shape[2]})")
        # the slot's whole S rows, as the reference: rows past `end` are
        # masked, but the attention sums then run over the same length
        kd, vd = bitplane_ops.unpack_kv_pair(kp, vp, bits, bits)
        kd[:, cache_len:end] = k.to(kd.dtype)
        vd[:, cache_len:end] = v.to(vd.dtype)
        out = flash_ops.flash_attention(q, kd, vd, q_pos=pos, kv_valid=end,
                                        window=window)
        # in place: the reference's dynamic_update_slice of the packed rows
        bitplane_ops.pack_kv_into(k, v, kp, vp, int(cache_len))
        return out
    # decode: pack-append the token at each row's own position (the
    # reference's kp.at[:, rows, clip(len, 0, S - 1)].set, in place), then
    # the partial-plane kernel (per-slot valid lengths and ladders).  Idle
    # rows append garbage at their own position, masked for every real query.
    # A ring appends at slot ln % S (computed here, so the kernel's clamp
    # never acts) and publishes the token's position.
    ln = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if ln.dim() == 0:
        ln = ln.expand(kp.shape[1])
    slot = ln % kp.shape[2] if ring else ln
    bitplane_ops.pack_kv_into(k, v, kp, vp, slot)
    if ring:
        cpos[torch.arange(kp.shape[1], device=q.device), slot.long()] = ln
    out = batched_ladder_paged_attention(
        q, kp, vp, kv_planes, ln + 1,
        keeps=tuple(keeps) if keeps is not None else (bits,),
        bits=bits, q_pos=pos, kv_pos=cpos, window=window, kernel=decode_kernel,
    )
    return out.to(q.dtype)


def attn_apply(params, x, cfg, *, pos, cache=None, cache_len=None,
               kv_planes=None, keeps=None, decode_kernel="fused",
               append_valid=None):
    """One attention sub-layer (reference ``attn_apply``: the ``cache=None``,
    dense per-row / prefill-append, ring and bit-plane branches).

    x: (B, S, d); pos: (B, S) absolute positions.  cache: None (causal
    self-attention over x, the new (k, v) returned for building a cache),
    a dense (k, v) pair of (B, S_cache, Hkv, hd) rows, a dense ring (k, v,
    kv_pos) with kv_pos (B, window) int32, or a bit-plane (k_planes,
    v_planes[, kv_pos]) tuple — each updated IN PLACE.  cache_len: int
    (prefill chunk appended at that offset) or (B,) per-row lengths
    (continuous-batching decode, one token per row).  The attention window
    is ``cfg.attn_window`` (0 = full causal).  ``append_valid``: the
    absolute end of a ring chunk's REAL tokens (a right-padded ragged tail
    writes none of its pad into the ring).
    Returns (y, new_kv) — new_kv is the projected (k, v) when cache is None.
    """
    window = cfg.attn_window
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
        out = flash_ops.flash_attention(q, k, v, q_pos=pos, kv_valid=pos[:, -1] + 1,
                                        window=window)
        new_kv = (k, v)
    elif cache[0].dtype == torch.uint8:
        out = _bitplane_cache_step(q, k, v, cache, pos=pos,
                                   cache_len=cache_len, kv_planes=kv_planes,
                                   keeps=keeps, window=window,
                                   append_valid=append_valid,
                                   decode_kernel=decode_kernel)
    elif len(cache) == 3:
        ck, cv, cpos = cache
        w = ck.shape[1]
        if s > 1:
            out = _ring_chunk_append(q, k, v, ck, cv, cpos, pos=pos, cache_len=cache_len,
                                     append_valid=append_valid, window=window)
        else:
            # per-row lengths (continuous batching: idle and mid-prefill
            # rows append a dummy token at their own next slot, masked for
            # every real query) or one aligned length; in place: the
            # reference's ck.at[rows, len % w].set
            ln = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
            ln = ln.expand(b) if ln.dim() == 0 else ln
            rows = torch.arange(b, device=x.device)
            slot = (ln % w).long()
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            cpos[rows, slot] = ln.to(cpos.dtype)
            out = decode_attention(q, ck, cv, q_pos=pos, kv_valid=ln + 1,
                                   window=window, kv_pos=cpos)
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
        out = decode_attention(q, ck, cv, q_pos=pos, kv_valid=cache_len + 1,
                               window=window)
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
            out = decode_attention(q, ck, cv, q_pos=pos, kv_valid=end, window=window)
        else:
            out = flash_ops.flash_attention(q, ck, cv, q_pos=pos, kv_valid=end,
                                            window=window)

    out = mask_padded_heads(out, cfg)
    y = out.reshape(b * s, -1) @ params["wo"].reshape(-1, d)
    return y.reshape(b, s, d), new_kv
