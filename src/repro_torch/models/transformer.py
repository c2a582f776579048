"""Decoder-only LM of the dense, MoE and VLM families (port of the
reference's ``models/transformer.py``: the training loss, the prefill and
the serving entry points).

The VLM family (LLaVA) is the dense LM with ``patch_proj`` (VISION_DIM, d):
a batch's precomputed patch embeddings are projected and prepended to the
text (:func:`embed_inputs`), and serve through the same caches.

Parameters are a nested dict in the reference's layout — layer tensors
stacked on axis 0 — so weights carry across bit-exactly
(:mod:`repro_torch.models.convert`).  A Python loop over layers replaces
``lax.scan``.

Caches: dense ``{'k','v': (L, B, S, Hkv, hd) bf16, 'len'}`` or bit-plane
``{'k_planes','v_planes': (L, bits, B, S, Hkv, hd//8) uint8, 'planes':
(B, S/16) int32, 'len'}``.  A sliding-window config's cache is a ring of
S = window slots and carries ``'pos': (L, B, S) int32``, each slot's
absolute position (-1 = unfilled).  A config with ``decode_staging`` =
ws > 0 gets a staged cache: ``'sk', 'sv': (L, B, ws, Hkv, hd)``, a
staging ring that decode appends to while the main cache stays read-only,
folded back every ws steps (:func:`flush_staging`, or per row under
continuous batching, where the cache also carries ``'sbase': (B,)``, each
row's first staged position).  Where the reference returns a new cache,
these functions write the same rows into the given cache tensors in place
and return the same dict.

The loss (:func:`lm_loss`) is the reference's: the stack over the whole
sequence (each layer under ``torch.utils.checkpoint`` where ``cfg.remat``
asks for rematerialisation, which changes memory, not numbers), the final
norm, and :func:`chunked_ce` over the labels, plus 0.01 x the MoE layers'
load-balance loss.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention.ops import pack_kv_planes
from repro_torch.models.attention import attn_apply, attn_params, project_out, project_qkv
from repro_torch.models.frontends import VISION_DIM
from repro_torch.models.moe import moe_apply, moe_params
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
    stack_layers,
    stack_layers_from,
)


def block_params(generator: torch.Generator, cfg, dtype) -> dict:
    """One pre-norm block's weights {ln1, attn, ln2, mlp (``cfg.act``)}, or
    {..., moe} for the MoE family."""
    d, dev = cfg.d_model, generator.device
    p = {
        "ln1": rmsnorm_params(d, dtype, dev),
        "attn": attn_params(generator, cfg, dtype),
        "ln2": rmsnorm_params(d, dtype, dev),
    }
    if cfg.family == "moe":
        p["moe"] = moe_params(generator, cfg, dtype)
    else:
        p["mlp"] = mlp_params(generator, d, cfg.d_ff, cfg.act, dtype)
    return p


def init_lm_params(cfg, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn from ``generator``
    (on the device the parameters should live on)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"family {cfg.family!r} is not a decoder-only LM of this module "
            f"(dense, moe and vlm)")
    dtype = pdtype(cfg)
    d = cfg.d_model
    embed = embed_params(generator, cfg.vocab_padded, d, dtype)
    layers = stack_layers_from(lambda: block_params(generator, cfg, dtype), cfg.n_layers)
    params = {"embed": embed, "layers": layers,
              "final_norm": rmsnorm_params(d, dtype, generator.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": he_init((cfg.vocab_padded, d), generator, dtype)}
    if cfg.family == "vlm":
        params["patch_proj"] = he_init((VISION_DIM, d), generator, dtype)
    return params


def head_weight(params: dict) -> torch.Tensor:
    return params.get("lm_head", {"w": params["embed"]["table"]})["w"]


def split_layer_params(params: dict) -> list:
    """Per-layer weight handles: views into the stacked ``params["layers"]``
    tree, one tree per layer (no second copy).  The weight store ingests
    these; the model keeps running the stacked form."""
    layers = params["layers"]
    n = next(iter(named_layer_tensors(layers)))[1].shape[0]
    return [layer_slice(layers, i) for i in range(n)]


def join_layer_params(handles: list) -> dict:
    """Inverse of :func:`split_layer_params`: the handles stacked back into
    a ``params["layers"]`` tree."""
    return stack_layers(handles)


def named_layer_tensors(handle: dict, prefix: str = "") -> list:
    """One layer handle flattened to ``(path, tensor)`` pairs in the
    reference's order (keys sorted at every level, as JAX flattens a dict):
    the stable tensor names ("attn/wq", "mlp/w_in", ...) the weight store
    keys on."""
    out = []
    for key in sorted(handle):
        value, name = handle[key], prefix + str(key)
        if isinstance(value, dict):
            out.extend(named_layer_tensors(value, name + "/"))
        else:
            out.append((name, value))
    return out


def block_apply(lp, x, cfg, *, pos, cache=None, cache_len=None, kv_planes=None,
                keeps=None, decode_kernel="fused", append_valid=None,
                inference=None, stage_base=None):
    """One pre-norm transformer block {ln1, attn, ln2, mlp or moe} over x
    (B, S, d) (the dense, MoE and VLM families' layer and Zamba2's shared
    block).  The cache arguments are :func:`attn_apply`'s.  The MoE layer
    takes the inference capacity when ``inference`` (default: a cache is
    given; a whole-prompt prefill passes True), the training one
    otherwise, as the reference.  Returns (x, new_kv): new_kv is the
    projected (k, v) when ``cache`` is None."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn_out, new_kv = attn_apply(lp["attn"], h, cfg, pos=pos, cache=cache,
                                  cache_len=cache_len, kv_planes=kv_planes,
                                  keeps=keeps, decode_kernel=decode_kernel,
                                  append_valid=append_valid, stage_base=stage_base)
    inference = cache is not None if inference is None else inference
    return block_tail(lp, x, attn_out, cfg, inference)[0], new_kv


def block_tail(lp, x, attn_out, cfg, inference: bool):
    """The block after its attention: the residual add, ln2 and the MLP or
    MoE branch (the MoE layer at the inference capacity when
    ``inference``).  Returns (x, aux): aux is the MoE layer's load-balance
    loss, None for an MLP."""
    # the reference's compiled layer fuses this residual add into the norm
    # after it and keeps the sum in float32 there; the residual stream
    # itself is stored rounded
    h2 = rmsnorm(x.float() + attn_out.float(), lp["ln2"], cfg.norm_eps).to(x.dtype)
    x = x + attn_out
    if "moe" in lp:
        ffn, aux = moe_apply(lp["moe"], h2, cfg, inference=inference)
        return x + ffn, aux
    return x + mlp_apply(lp["mlp"], h2, cfg.act), None


def run_stack(params, cfg, x, pos, cache=None, keeps=None, decode_kernel="fused",
              want_cache=False):
    """x: (B, S, d); pos: (B, S).  cache: None (plain causal forward) or a
    serving cache dict (dense or bit-plane, ring or staged or neither, see
    the module docstring) whose rows are appended in place; a ring chunk's
    cache also carries ``'valid'``, the absolute end of the chunk's real
    tokens, and a staged cache under continuous batching ``'sbase'``.
    ``keeps``/``decode_kernel`` steer bit-plane decode.  Returns the final
    hidden states (B, S, d); with ``want_cache`` (a whole-prompt prefill,
    no cache given) also the new dense cache {'k', 'v': (L, B, S, Hkv,
    hd)}, each layer's projected keys and values written into it as the
    layer runs, and the MoE layers at the inference capacity."""
    cache_len = None if cache is None else cache["len"]
    if torch.is_tensor(cache_len) and cache_len.dim() == 0:
        # one length for every row (a whole-prompt prefill's cache): read
        # it once a step, not once a layer
        cache_len = int(cache_len)
    bitplane = cache is not None and "k_planes" in cache
    ring = cache is not None and "pos" in cache
    staged = cache is not None and "sk" in cache
    append_valid = None if cache is None else cache.get("valid")
    stage_base = None if cache is None else cache.get("sbase")
    kn, vn = ("k_planes", "v_planes") if bitplane else ("k", "v")
    kv_planes = cache.get("planes") if bitplane else None
    new = None
    if want_cache:
        if cache is not None:
            raise ValueError("want_cache builds a new cache: pass no cache")
        shape = (cfg.n_layers,) + tuple(x.shape[:2]) + (cfg.n_kv_heads, cfg.head_dim)
        new = {name: x.new_empty(shape) for name in ("k", "v")}
    for i in range(cfg.n_layers):
        kv = None
        if cache is not None:
            kv = (cache[kn][i], cache[vn][i]) + ((cache["pos"][i],) if ring else ())
            if staged:
                kv = kv + (cache["sk"][i], cache["sv"][i])
        x, new_kv = block_apply(layer_slice(params["layers"], i), x, cfg, pos=pos,
                                cache=kv, cache_len=cache_len, kv_planes=kv_planes,
                                keeps=keeps, decode_kernel=decode_kernel,
                                append_valid=append_valid,
                                inference=True if want_cache else None,
                                stage_base=stage_base)
        if new is not None:
            new["k"][i], new["v"][i] = new_kv
    return (x, new) if want_cache else x


def train_block(lp, x, pos, cfg, remat: bool = False):
    """One block of the training forward over the whole sequence ((x, aux),
    the numbers :func:`block_apply` gives without a cache).  With
    ``remat`` (the reference's ``cfg.remat``, which recomputes the layer in
    its backward) the layer runs as two ``torch.utils.checkpoint``
    segments, before and after the flash call: everything but the flash
    attention is recomputed in the backward, and flash, whose backward
    recomputes its scores from the (q, k, v, out, lse) it saves anyway,
    runs once.  Memory changes, the numbers do not."""

    def before(x):
        return project_qkv(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, pos)

    def after(x, out):
        x, aux = block_tail(lp, x, project_out(lp["attn"], out, cfg), cfg, inference=False)
        return x, x.new_zeros((), dtype=torch.float32) if aux is None else aux

    ckpt = torch.utils.checkpoint.checkpoint
    q, k, v = ckpt(before, x, use_reentrant=False) if remat else before(x)
    out = flash_ops.flash_attention(q, k, v, q_pos=pos, kv_valid=pos[:, -1] + 1,
                                    window=cfg.attn_window)
    return ckpt(after, x, out, use_reentrant=False) if remat else after(x, out)


def embed_inputs(params, cfg, batch: dict):
    """batch {'tokens': (B, S) int[, 'patches': (B, P, VISION_DIM)]} ->
    (x (B, S', d), pos (B, S')): the VLM family's patches projected
    through ``patch_proj`` (in the storage dtype) and prepended, S' = P +
    S; positions 0..S'-1."""
    x = embed_apply(params["embed"], batch["tokens"].long())
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    return x, pos


def chunked_ce(x_final, head_w, labels, vocab_real: int, chunk: int = 1024):
    """Mean cross-entropy without the (B, S, V) logits (reference
    ``chunked_ce``): the sequence in chunks of ``chunk`` positions, each
    chunk's logits a bf16 product (``torch.matmul``, as the reference
    leaves it to XLA) taken to float32, the padded vocabulary masked,
    log-sum-exp minus the gold logit summed over labels >= 0 (-1 =
    ignore), divided by their count.  Float32."""
    b, s, d = x_final.shape
    chunk = int(min(chunk, s))
    vmask = torch.arange(head_w.shape[0], device=x_final.device) < vocab_real
    nll = x_final.new_zeros((), dtype=torch.float32)
    count = x_final.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        logits = (x_final[:, c0:c0 + chunk] @ head_w.T).float()
        logits = torch.where(vmask, logits, torch.full_like(logits, -1e30))
        li = labels[:, c0:c0 + chunk].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, torch.clamp(li, min=0)[..., None])[..., 0]
        valid = (li >= 0).float()
        nll = nll + ((logz - gold) * valid).sum()
        count = count + valid.sum()
    return nll / torch.clamp(count, min=1.0)


def lm_loss(params, cfg, batch: dict):
    """batch {'tokens', 'labels': (B, S) int[, 'patches': (B, P,
    VISION_DIM)]} -> the scalar float32 training loss (reference
    ``lm_loss``): the stack over the whole sequence (MoE layers at the
    training capacity, their load-balance losses summed), the final norm,
    :func:`chunked_ce` over the labels — a VLM's patch positions get label
    -1 — plus 0.01 x the load-balance sum.  Each layer is rematerialised
    in the backward where ``cfg.remat`` asks for it (:func:`train_block`)."""
    x, pos = embed_inputs(params, cfg, batch)
    remat = bool(cfg.remat) and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)
    for i in range(cfg.n_layers):
        x, a = train_block(layer_slice(params["layers"], i), x, pos, cfg, remat)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    labels = batch["labels"]
    if cfg.family == "vlm":
        p = x.shape[1] - labels.shape[1]
        labels = torch.cat([labels.new_full((labels.shape[0], p), -1), labels], dim=1)
    return chunked_ce(x, head_weight(params), labels, cfg.vocab) + 0.01 * aux


def lm_prefill(params, cfg, batch: dict):
    """Whole-prompt prefill (the reference's ``lm_prefill``): returns
    (last-token logits (B, Vpad) float32, cache {'k', 'v': (L, B, S', Hkv,
    hd), 'len': S'}), S' counting a VLM's patches.  Attention runs through
    the flash kernel on the card, as the chunked prefill does."""
    x, pos = embed_inputs(params, cfg, batch)
    x, cache = run_stack(params, cfg, x, pos, want_cache=True)
    cache["len"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


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
    written in place; the chunk attends to the slot's rows [0, start).  A
    ring cache (``'pos'``) takes the ring chunk append instead: the real
    tokens land at slots ``p % window`` (the pad is never written, so it
    cannot clobber older in-window entries) and the chunk attends over the
    ring's old entries and itself; the serving stack caps the chunk at the
    window.
    Returns (logits (1, Vpad) float32 at chunk index ``last_idx``, cache).
    """
    bitplane = "k_planes" in cache
    kn, vn, slot_ax = ("k_planes", "v_planes", 2) if bitplane else ("k", "v", 1)
    sub = {kn: cache[kn].narrow(slot_ax, slot, 1),
           vn: cache[vn].narrow(slot_ax, slot, 1), "len": int(start)}
    if "pos" in cache:
        sub["pos"] = cache["pos"].narrow(1, slot, 1)
        sub["valid"] = int(start) + int(last_idx) + 1
    x = embed_apply(params["embed"], tokens)
    c = x.shape[1]
    pos = start + torch.arange(c, dtype=torch.int32, device=x.device)[None]
    x = run_stack(params, cfg, x, pos, cache=sub)
    logits = _logits(params, cfg, x[:, last_idx:last_idx + 1])[:, 0]
    return logits, cache


def lm_decode(params, cfg, token, cache, keeps=None, decode_kernel="fused"):
    """token: (B,) int; cache['len']: (B,) per-row lengths (continuous
    batching: each slot decodes at its own position against its own valid
    prefix) or one length for every row (a cache from :func:`lm_prefill`).  Bit-plane caches take ``keeps`` — the plane counts the ladder
    can assign — and run decode attention through the paged-attention
    kernel (``decode_kernel``: "fused" = one launch per layer, "rung" = one
    launch per member of ``keeps``).  Returns (logits (B, Vpad) float32,
    cache) with the new token's rows written in place."""
    x = embed_apply(params["embed"], token[:, None])
    ln = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    pos = ln.expand(x.shape[0])[:, None]
    x = run_stack(params, cfg, x, pos, cache=cache, keeps=keeps,
                  decode_kernel=decode_kernel)
    logits = _logits(params, cfg, x)[:, 0]
    cache["len"] = ln + 1
    if "sbase" in cache:
        ws = cache["sk"].shape[2]
        staged_n = ln - cache["sbase"]
        cache["sbase"] = cache["sbase"] + torch.where(
            (staged_n >= 0) & (staged_n + 1 == ws), ws, 0).to(torch.int32)
    return logits, cache


def init_decode_cache(cfg, batch: int, max_len: int, device,
                      dtype=None) -> dict:
    """Zeroed dense serving cache.  A sliding-window config gets a ring of
    the window's size (the cache for a ``max_len`` context is bounded by
    the window) with its ``'pos'`` plane at -1 (unfilled); otherwise a
    config with ``decode_staging`` > 0 gets the zeroed staging ring
    ``'sk', 'sv'``."""
    ring = 0 < cfg.attn_window < max_len
    dtype = dtype or pdtype(cfg)
    s_cache = cfg.attn_window if ring else max_len
    shape = (cfg.n_layers, batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
    if ring:
        cache["pos"] = torch.full((cfg.n_layers, batch, s_cache), -1,
                                  dtype=torch.int32, device=device)
    elif cfg.decode_staging > 0:
        cache.update(_staging(cfg, batch, dtype, device))
    return cache


def _staging(cfg, batch: int, dtype, device) -> dict:
    shape = (cfg.n_layers, batch, cfg.decode_staging, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name in ("sk", "sv")}


def flush_staging(cache: dict, cfg) -> dict:
    """Fold the staging ring into the main cache (reference
    ``flush_staging``, run every ``cfg.decode_staging`` steps of an aligned
    batch): the ring's ws rows land at rows [len - staged, ...) of 'k' and
    'v' (at a flush boundary, len % ws == 0, the ring holds ws entries;
    the start clamped so the rows fit, as a dynamic_update_slice clamps
    it), and the ring is zeroed.  In place; returns the same dict."""
    ws = cache["sk"].shape[2]
    ln = int(cache["len"])
    start = ln - ((ln - 1) % ws + 1)
    start = max(0, min(start, cache["k"].shape[2] - ws))
    for name, staged in (("k", "sk"), ("v", "sv")):
        cache[name][:, :, start:start + ws] = cache[staged].to(cache[name].dtype)
        cache[staged].zero_()
    return cache


def ring_cache_from_prefill(cache: dict, cfg, max_len: int) -> dict:
    """A full-length prefill cache {'k','v','len'} made ready for decode up
    to ``max_len`` tokens of context (reference
    ``ring_cache_from_prefill``): a sliding-window config gets a ring of
    the window's size holding the last ``window`` prefill tokens at slots
    ``pos % window``; a full-attention one gets its sequence axis padded
    with zero rows (never cut), and a staged config its zeroed staging
    ring."""
    s = cache["k"].shape[2]
    w = cfg.attn_window
    if not (0 < w < max_len):
        out = dict(cache)
        for name in ("k", "v"):
            if s < max_len:
                out[name] = torch.nn.functional.pad(cache[name], (0, 0, 0, 0, 0, max_len - s))
        if cfg.decode_staging > 0 and "sk" not in out:
            out.update(_staging(cfg, out["k"].shape[1], out["k"].dtype, out["k"].device))
        return out
    keep = min(s, w)
    ln = int(cache["len"])
    abs_pos = ln - keep + torch.arange(keep, dtype=torch.int32, device=cache["k"].device)
    slots = (abs_pos % w).long()
    out = {"len": cache["len"]}
    for name in ("k", "v"):
        tail = cache[name][:, :, s - keep:]
        ring = tail.new_zeros(tail.shape[:2] + (w,) + tail.shape[3:])
        ring[:, :, slots] = tail
        out[name] = ring
    l, b = cache["k"].shape[:2]
    pos = torch.full((l, b, w), -1, dtype=torch.int32, device=cache["k"].device)
    pos[:, :, slots] = abs_pos
    out["pos"] = pos
    return out


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
