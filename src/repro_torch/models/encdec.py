"""Encoder-decoder LM, the Whisper family (port of the reference's
``models/encdec.py``).

The conv audio frontend is a stub (:mod:`repro_torch.models.frontends`):
the encoder takes precomputed frame embeddings at ``d_model``.  Positions are sinusoidal, added to the frames and to the
decoder's token embeddings; attention takes no rotary embedding.

Parameters are the reference's tree, each stack's tensors on a leading
layer axis: ``enc_layers`` {ln1, attn, ln2, mlp}, ``dec_layers`` {ln1,
self_attn, ln2, cross_attn, ln3, mlp}, ``enc_final``, ``dec_final``,
``embed`` and ``lm_head``.

Cache (decode): per decoder layer a self-attention KV cache and a cross-
attention KV cache projected once from the encoder's output at prefill,
``{'self_k', 'self_v': (L, B, S, Hkv, hd), 'cross_k', 'cross_v': (L, B,
S_enc, Hkv, hd), 'len'}``.  The cross KV is static per request.  Prefill
returns a new cache; decode writes the token's self-attention k/v into
row ``len`` of the given cache in place (as the dense family does), so a
prefill cache is padded first (``models.model.prepare_decode_cache``).

The encoder's self attention and every attention of a prefill run through
the flash kernel on the card (bidirectional ones with ``causal=False``);
a one-token decode step attends through the plain
:func:`~repro_torch.models.attention.decode_attention`, as the reference.
The training loss (:func:`encdec_loss`) differentiates through the flash
kernel's backward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models.layers import (
    embed_apply,
    embed_params,
    he_init,
    layer_slice,
    mlp_apply,
    mlp_params,
    pdtype,
    rmsnorm,
    rmsnorm_params,
    sinusoidal_positions,
    stack_layers,
    stack_layers_from,
)


def init_encdec_params(cfg, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn from ``generator``
    on the device the parameters should live on."""
    dtype = pdtype(cfg)
    d, dev = cfg.d_model, generator.device

    def enc_layer():
        return {"ln1": rmsnorm_params(d, dtype, dev),
                "attn": A.attn_params(generator, cfg, dtype),
                "ln2": rmsnorm_params(d, dtype, dev),
                "mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype)}

    def dec_layer():
        return {"ln1": rmsnorm_params(d, dtype, dev),
                "self_attn": A.attn_params(generator, cfg, dtype),
                "ln2": rmsnorm_params(d, dtype, dev),
                "cross_attn": A.attn_params(generator, cfg, dtype),
                "ln3": rmsnorm_params(d, dtype, dev),
                "mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype)}

    params = {
        "embed": embed_params(generator, cfg.vocab_padded, d, dtype),
        "enc_layers": stack_layers_from(enc_layer, cfg.n_enc_layers),
        "dec_layers": stack_layers_from(dec_layer, cfg.n_layers),
        "enc_final": rmsnorm_params(d, dtype, dev),
        "dec_final": rmsnorm_params(d, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": he_init((cfg.vocab_padded, d), generator, dtype)}
    return params


def _head_w(params: dict) -> torch.Tensor:
    return params.get("lm_head", {"w": params["embed"]["table"]})["w"]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd), one bf16 product."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])


def _attn(p: dict, xq, xkv, cfg, *, q_pos, bidirectional: bool, kv=None,
          kv_valid=None, cache=None, cache_len=None):
    """Projection and attention (reference ``_attn``).  ``kv`` given: a
    precomputed (k, v) pair (cross attention at decode).  ``cache`` given:
    a self-attention cache (k, v) of (B, S, Hkv, hd) rows, the new rows
    written at ``cache_len`` IN PLACE and attended to with every row
    before them.  Several query tokens attend through the flash kernel
    (bidirectional: ``causal=False``), one through
    :func:`decode_attention`.  Returns (y (B, Sq, d), (k, v)): the
    projected pair, or the cache's."""
    b, sq, d = xq.shape
    q = _project(xq, p["wq"])
    if kv is None:
        k, v = _project(xkv, p["wk"]), _project(xkv, p["wv"])
    else:
        k, v = kv
    new_kv = (k, v)
    if cache is not None:
        ck, cv = cache
        end = int(cache_len) + sq
        if end > ck.shape[1]:
            raise ValueError(
                f"{sq} token(s) at {int(cache_len)} overrun the cache of "
                f"{ck.shape[1]} rows; pad it first (prepare_decode_cache)")
        # in place: the reference's dynamic_update_slice at cache_len
        ck[:, int(cache_len):end] = k.to(ck.dtype)
        cv[:, int(cache_len):end] = v.to(cv.dtype)
        k, v = ck, cv
        new_kv = (ck, cv)
        kv_valid = end
    if kv_valid is None:
        kv_valid = k.shape[1] if bidirectional else q_pos[:, -1] + 1
    if sq == 1:
        out = A.decode_attention(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                               bidirectional=bidirectional)
    else:
        out = flash_ops.flash_attention(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                        causal=not bidirectional)
    out = A.mask_padded_heads(out, cfg)
    y = out.reshape(b * sq, -1) @ p["wo"].reshape(-1, d)
    return y.reshape(b, sq, d), new_kv


def _add_norm(x, a, ln, cfg):
    """(x + a, rmsnorm(x + a)): the reference's compiled layer fuses the
    residual add into the norm after it and keeps the sum in float32 there
    (the dense block's rounding point); the stream itself is stored
    rounded."""
    h = rmsnorm(x.float() + a.float(), ln, cfg.norm_eps).to(x.dtype)
    return x + a, h


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params: dict, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d) -> encoder output (B, S_enc, d): sinusoidal
    positions added, bidirectional self attention, the final norm."""
    dtype = pdtype(cfg)
    b, s, d = frames.shape
    x = frames.to(dtype) + sinusoidal_positions(s, d, device=frames.device).to(dtype)[None]
    pos = _positions(b, s, x.device)
    for i in range(cfg.n_enc_layers):
        lp = layer_slice(params["enc_layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = _attn(lp["attn"], h, h, cfg, q_pos=pos, bidirectional=True)
        x, h = _add_norm(x, a, lp["ln2"], cfg)
        x = x + mlp_apply(lp["mlp"], h, cfg.act)
    return rmsnorm(x, params["enc_final"], cfg.norm_eps)


def _dec_stack(params: dict, cfg, x, pos, enc_out, cache=None, want_cache=False):
    """The decoder over x (B, S, d) (reference ``_dec_stack``).  Prefill
    (``cache`` None): self attention causal over x, cross attention over
    ``enc_out``; with ``want_cache`` the new cache's four stacks.  Decode:
    the cache's self rows appended in place at ``cache['len']`` and its
    cross k/v attended.  Returns (x, cache or None)."""
    cache_len = int(cache["len"]) if cache is not None else 0
    stacks = [] if want_cache and cache is None else None
    for i in range(cfg.n_layers):
        lp = layer_slice(params["dec_layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        self_cache = None if cache is None else (cache["self_k"][i], cache["self_v"][i])
        a, self_kv = _attn(lp["self_attn"], h, h, cfg, q_pos=pos, bidirectional=False,
                           cache=self_cache, cache_len=cache_len)
        x, h = _add_norm(x, a, lp["ln2"], cfg)
        if cache is None:
            c, cross_kv = _attn(lp["cross_attn"], h, enc_out, cfg, q_pos=pos,
                                bidirectional=True)
        else:
            ck = cache["cross_k"][i]
            c, cross_kv = _attn(lp["cross_attn"], h, None, cfg, q_pos=pos,
                                bidirectional=True, kv=(ck, cache["cross_v"][i]),
                                kv_valid=ck.shape[1])
        x, h = _add_norm(x, c, lp["ln3"], cfg)
        x = x + mlp_apply(lp["mlp"], h, cfg.act)
        if stacks is not None:
            stacks.append({"self_k": self_kv[0], "self_v": self_kv[1],
                           "cross_k": cross_kv[0], "cross_v": cross_kv[1]})
    if stacks is not None:
        return x, stack_layers(stacks)
    return x, cache


def encdec_loss(params, cfg, batch):
    """batch {'frames': (B, S_enc, d), 'tokens', 'labels': (B, S) int} ->
    the scalar float32 training loss (reference ``encdec_loss``): the
    encoder, the decoder over the token embeddings plus sinusoidal
    positions, the final norm and
    :func:`~repro_torch.models.transformer.chunked_ce` over the labels.
    Every attention differentiates through the flash kernel's backward on
    the card.  No rematerialisation, as the reference's stacks have none."""
    from repro_torch.models.transformer import chunked_ce

    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_apply(params["embed"], tokens.long())
    x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(x.dtype)[None]
    x, _ = _dec_stack(params, cfg, x, _positions(b, s, x.device), enc_out)
    x = rmsnorm(x, params["dec_final"], cfg.norm_eps)
    return chunked_ce(x, _head_w(params), batch["labels"], cfg.vocab)


def _logits(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["dec_final"], cfg.norm_eps)
    return (x @ _head_w(params).T)[:, 0].float()


def encdec_prefill(params: dict, cfg, batch: dict):
    """batch {'frames': (B, S_enc, d), 'tokens': (B, S) int} -> (last-token
    logits (B, Vpad) float32, cache with S self rows)."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_apply(params["embed"], tokens.long())
    x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(x.dtype)[None]
    x, cache = _dec_stack(params, cfg, x, _positions(b, s, x.device), enc_out,
                          want_cache=True)
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x[:, -1:]), cache


def encdec_decode(params: dict, cfg, token: torch.Tensor, cache: dict):
    """token (B,) int -> (logits (B, Vpad) float32, cache): the token's
    self-attention k/v land in row ``cache['len']`` of every layer's self
    cache in place, and ``len`` advances; raises when that row lies past
    the cache (pad it first)."""
    x = embed_apply(params["embed"], token.long()[:, None])
    offs = int(cache["len"])
    # the one-position sinusoid at the offset, as the reference writes it
    # here: float32 log(10000) divided in float32
    half = cfg.d_model // 2
    rate = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=x.device)) / max(1, half - 1)
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device) * rate)
    ang = float(offs) * inv
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(x.dtype)[None, None, :]
    pos = torch.full((x.shape[0], 1), offs, dtype=torch.int32, device=x.device)
    x, cache = _dec_stack(params, cfg, x, pos, None, cache=cache)
    cache["len"] = cache["len"] + 1
    return _logits(params, cfg, x), cache


def init_encdec_cache(cfg, batch: int, max_len: int, device, dtype=None) -> dict:
    dtype = dtype or pdtype(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dec = (cfg.n_layers, batch, max_len, hkv, hd)
    cross = (cfg.n_layers, batch, cfg.enc_seq, hkv, hd)
    return {
        "self_k": torch.zeros(dec, dtype=dtype, device=device),
        "self_v": torch.zeros(dec, dtype=dtype, device=device),
        "cross_k": torch.zeros(cross, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        "len": torch.tensor(0, dtype=torch.int32, device=device),
    }
