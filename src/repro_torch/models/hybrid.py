"""SSM LM (Mamba2 family) and hybrid Mamba2 + shared-attention LM
(Zamba2): port of the reference's ``models/hybrid.py``.

Parameters are a nested dict in the reference's layout, each layer's
tensors stacked on a leading layer axis, so weights carry across bit for
bit (:mod:`repro_torch.models.convert`); Python loops over those axes
replace ``lax.scan``.

Mamba2: decode caches are the stacked Mamba states, O(1) in the context
length: ``{'layers': {'state': (L, B, H, N, P) f32, 'conv_x', 'conv_b',
'conv_c': (L, B, W-1, C) bf16}, 'len'}``.  Like the reference, prefill and
decode return new caches and leave the given one as it was.

Zamba2: ``n_layers`` slots; every ``attn_period``-th slot is one SHARED
transformer block (one parameter set, called ``n_attn`` times), the others
Mamba2 layers: ``n_attn`` segments of (period - 1) Mamba2 layers and one
shared-block call, then the tail's leftover Mamba2 layers.  Parameters:
``seg_layers`` (n_attn, seg_m, ...), ``tail_layers`` (tail, ...) (an
empty leading axis when tail = 0) and ``shared`` {ln1, attn, ln2, mlp},
the dense family's block (:func:`repro_torch.models.transformer.block_apply`)
with its rounding points.
Caches: ``{'seg_ssm': (n_attn, seg_m, ...), 'tail_ssm': (tail, ...), 'k',
'v': (n_attn, B, S, Hkv, hd), 'len'}``, one KV cache per shared-block call.
Prefill returns a new cache; decode returns new Mamba states but writes the
token's k/v into the given cache's k/v rows in place (as the dense family
does), so the cache must first be padded to the decode length
(``models.model.prepare_decode_cache``).

The training losses raise here: they need a backward of the SSD scan
(``csrc/ssd.cu`` is forward only) and come with the SSD-backward training
slice.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (
    embed_apply,
    embed_params,
    empty_layers,
    he_init,
    layer_slice,
    pdtype,
    rmsnorm,
    rmsnorm_params,
    stack_layers,
)
from repro_torch.models.ssm import ssm_apply, ssm_decode_step, ssm_init_cache, ssm_params
from repro_torch.models.transformer import block_apply, block_params


def _mamba_layer_params(generator: torch.Generator, cfg, dtype) -> dict:
    return {
        "ln": rmsnorm_params(cfg.d_model, dtype, generator.device),
        "ssm": ssm_params(generator, cfg, dtype),
    }


def _mamba_layer_seq(lp: dict, x: torch.Tensor, cfg, initial=None):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, cache = ssm_apply(lp["ssm"], h, cfg, initial=initial)
    return x + y, cache


def _mamba_layer_step(lp: dict, x_t: torch.Tensor, cache: dict, cfg):
    h = rmsnorm(x_t[:, None, :], lp["ln"], cfg.norm_eps)[:, 0]
    y, new_cache = ssm_decode_step(lp["ssm"], h, cache, cfg)
    return x_t + y, new_cache


def _head_w(params: dict) -> torch.Tensor:
    return params.get("lm_head", {"w": params["embed"]["table"]})["w"]


def hybrid_counts(cfg) -> tuple[int, int, int]:
    """(n_attn segments, Mamba2 layers per segment, tail Mamba2 layers)."""
    p = cfg.attn_period
    n_attn = cfg.n_layers // p
    return n_attn, p - 1, cfg.n_layers - n_attn * p


# ---------------------------------------------------------------------------
# SSM-only LM (mamba2)
# ---------------------------------------------------------------------------


def init_ssm_lm_params(cfg, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn from ``generator``
    on the device the parameters should live on."""
    dtype = pdtype(cfg)
    dev = generator.device
    embed = embed_params(generator, cfg.vocab_padded, cfg.d_model, dtype)
    layers = stack_layers([_mamba_layer_params(generator, cfg, dtype)
                           for _ in range(cfg.n_layers)])
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": rmsnorm_params(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": he_init((cfg.vocab_padded, cfg.d_model), generator, dtype)}
    return params


def _ssm_stack_seq(params: dict, cfg, x: torch.Tensor):
    """Every layer over the sequence; returns (x, stacked layer caches)."""
    caches = []
    for i in range(cfg.n_layers):
        x, layer_cache = _mamba_layer_seq(layer_slice(params["layers"], i), x, cfg)
        caches.append(layer_cache)
    return x, stack_layers(caches)


def ssm_lm_loss(params, cfg, batch):
    raise NotImplementedError(
        "ssm_lm_loss is not ported yet: it needs a backward of the SSD scan "
        "(csrc/ssd.cu is forward only) and comes with the SSD-backward "
        "training slice (ROADMAP queue 1)"
    )


def _logits(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Last hidden state (B, d) -> float32 logits over the PADDED vocabulary.
    Unlike the dense family's head, the reference masks no pad entry here
    (``hybrid.py`` ssm_lm_prefill/decode), so a greedy argmax may pick a pad
    id; the port keeps that behaviour."""
    x = rmsnorm(x[:, None, :], params["final_norm"], cfg.norm_eps)
    return (x @ _head_w(params).T)[:, 0].float()


def ssm_lm_prefill(params: dict, cfg, batch: dict):
    """batch {'tokens': (B, L) int} -> (last-token logits (B, Vpad) f32,
    decode cache)."""
    tokens = batch["tokens"]
    x = embed_apply(params["embed"], tokens.long())
    x, layer_caches = _ssm_stack_seq(params, cfg, x)
    cache = {"layers": layer_caches,
             "len": torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)}
    return _logits(params, cfg, x[:, -1]), cache


def ssm_lm_decode(params: dict, cfg, token: torch.Tensor, cache: dict):
    """token (B,) int -> (logits (B, Vpad) f32, new cache)."""
    x = embed_apply(params["embed"], token.long())
    new_caches = []
    for i in range(cfg.n_layers):
        x, layer_cache = _mamba_layer_step(layer_slice(params["layers"], i), x,
                                           layer_slice(cache["layers"], i), cfg)
        new_caches.append(layer_cache)
    return _logits(params, cfg, x), {"layers": stack_layers(new_caches),
                                     "len": cache["len"] + 1}


def init_ssm_lm_cache(cfg, batch: int, device, dtype=None) -> dict:
    one = ssm_init_cache(cfg, batch, device, dtype or pdtype(cfg))
    return {
        "layers": {k: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                                  device=device) for k, t in one.items()},
        "len": torch.tensor(0, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Hybrid LM (zamba2)
# ---------------------------------------------------------------------------


def _stacked_caches(caches: list, cfg, batch: int, device) -> dict:
    """Per-layer Mamba caches -> one tree on a leading layer axis; an empty
    list gives that tree with a leading axis of 0, as the reference's tail
    scan over no layers does."""
    if caches:
        return stack_layers(caches)
    return empty_layers(ssm_init_cache(cfg, batch, device, pdtype(cfg)))


def init_hybrid_params(cfg, generator: torch.Generator) -> dict:
    """Random weights in the reference's layout, drawn from ``generator``
    on the device the parameters should live on."""
    n_attn, seg_m, tail = hybrid_counts(cfg)
    dtype = pdtype(cfg)
    d = cfg.d_model

    def mamba(n):
        return stack_layers([_mamba_layer_params(generator, cfg, dtype) for _ in range(n)])

    embed = embed_params(generator, cfg.vocab_padded, d, dtype)
    seg_layers = stack_layers([mamba(seg_m) for _ in range(n_attn)])
    # an empty leading axis when tail = 0, as the reference keeps
    tail_layers = mamba(tail) if tail else empty_layers(
        layer_slice(layer_slice(seg_layers, 0), 0))
    params = {
        "embed": embed,
        "seg_layers": seg_layers,
        "tail_layers": tail_layers,
        "shared": block_params(generator, cfg, dtype),
        "final_norm": rmsnorm_params(d, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": he_init((cfg.vocab_padded, d), generator, dtype)}
    return params


def hybrid_loss(params, cfg, batch):
    raise NotImplementedError(
        "hybrid_loss is not ported yet: it needs a backward of the SSD scan "
        "(csrc/ssd.cu is forward only) and comes with the SSD-backward "
        "training slice (ROADMAP queue 1)"
    )


def hybrid_prefill(params: dict, cfg, batch: dict):
    """batch {'tokens': (B, L) int} -> (last-token logits (B, Vpad) f32,
    cache with L rows of k/v per shared-block call)."""
    n_attn, seg_m, tail = hybrid_counts(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_apply(params["embed"], tokens.long())
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    seg_caches, ks, vs = [], [], []
    for i in range(n_attn):
        seg_lp = layer_slice(params["seg_layers"], i)
        caches = []
        for j in range(seg_m):
            x, layer_cache = _mamba_layer_seq(layer_slice(seg_lp, j), x, cfg)
            caches.append(layer_cache)
        seg_caches.append(stack_layers(caches))
        x, (k, v) = block_apply(params["shared"], x, cfg, pos=pos)
        ks.append(k)
        vs.append(v)
    tail_caches = []
    for j in range(tail):
        x, layer_cache = _mamba_layer_seq(layer_slice(params["tail_layers"], j), x, cfg)
        tail_caches.append(layer_cache)
    cache = {
        "seg_ssm": stack_layers(seg_caches),
        "tail_ssm": _stacked_caches(tail_caches, cfg, b, x.device),
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "len": torch.tensor(s, dtype=torch.int32, device=x.device),
    }
    return _logits(params, cfg, x[:, -1]), cache


def hybrid_decode(params: dict, cfg, token: torch.Tensor, cache: dict):
    """token (B,) int -> (logits (B, Vpad) f32, new cache).  The token's
    k/v land in row ``cache['len']`` of the given cache's k/v, in place;
    raises when that row lies past the cache (pad it first)."""
    n_attn, seg_m, tail = hybrid_counts(cfg)
    x = embed_apply(params["embed"], token.long())
    n = int(cache["len"])
    pos = torch.full((x.shape[0], 1), n, dtype=torch.int32, device=x.device)
    seg_caches = []
    for i in range(n_attn):
        seg_lp = layer_slice(params["seg_layers"], i)
        seg_c = layer_slice(cache["seg_ssm"], i)
        caches = []
        for j in range(seg_m):
            x, layer_cache = _mamba_layer_step(layer_slice(seg_lp, j), x,
                                               layer_slice(seg_c, j), cfg)
            caches.append(layer_cache)
        seg_caches.append(stack_layers(caches))
        y, _ = block_apply(params["shared"], x[:, None, :], cfg, pos=pos,
                           cache=(cache["k"][i], cache["v"][i]), cache_len=n)
        x = y[:, 0]
    tail_caches = []
    for j in range(tail):
        x, layer_cache = _mamba_layer_step(layer_slice(params["tail_layers"], j), x,
                                           layer_slice(cache["tail_ssm"], j), cfg)
        tail_caches.append(layer_cache)
    new_cache = {
        "seg_ssm": stack_layers(seg_caches),
        "tail_ssm": _stacked_caches(tail_caches, cfg, x.shape[0], x.device),
        "k": cache["k"],
        "v": cache["v"],
        "len": cache["len"] + 1,
    }
    return _logits(params, cfg, x), new_cache


def init_hybrid_cache(cfg, batch: int, max_len: int, device, dtype=None) -> dict:
    dtype = dtype or pdtype(cfg)
    n_attn, seg_m, tail = hybrid_counts(cfg)
    one = ssm_init_cache(cfg, batch, device, dtype)
    kv_shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "seg_ssm": {k: torch.zeros((n_attn, seg_m) + tuple(t.shape), dtype=t.dtype,
                                   device=device) for k, t in one.items()},
        "tail_ssm": {k: torch.zeros((tail,) + tuple(t.shape), dtype=t.dtype,
                                    device=device) for k, t in one.items()},
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "len": torch.tensor(0, dtype=torch.int32, device=device),
    }
