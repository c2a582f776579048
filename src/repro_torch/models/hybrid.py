"""SSM LM (Mamba2 family): the SSM-only part of the reference's
``models/hybrid.py``.

Parameters are a nested dict in the reference's layout, each layer's
tensors stacked on a leading ``n_layers`` axis, so weights carry across bit
for bit (:mod:`repro_torch.models.convert`); a Python loop over that axis
replaces ``lax.scan``.  Decode caches are the stacked Mamba states, O(1) in
the context length: ``{'layers': {'state': (L, B, H, N, P) f32, 'conv_x',
'conv_b', 'conv_c': (L, B, W-1, C) bf16}, 'len'}``.  Like the reference,
prefill and decode return new caches and leave the given one as it was.

The hybrid Mamba2 + shared-attention LM (Zamba2) comes with a later slice
(``build_model`` raises for it); the training loss raises here.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (
    embed_apply,
    embed_params,
    he_init,
    layer_slice,
    pdtype,
    rmsnorm,
    rmsnorm_params,
    stack_layers,
)
from repro_torch.models.ssm import ssm_apply, ssm_decode_step, ssm_init_cache, ssm_params


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
        "ssm_lm_loss is not ported yet: it comes with the training slice "
        "(ROADMAP queue 1 item 5)"
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
