"""Model API of the port: the dense, SSM and hybrid branches of the
reference's ``models/model.py::build_model``, and the hybrid part of its
``prepare_decode_cache``.

``build_model(cfg)`` returns a model whose methods keep the reference's
call shapes (parameters are passed in, as in JAX, so the serving stack,
the step functions and the parity tests hand the same nested dict around).

Dense (:class:`Model`):

    init(generator=None, device=None)                 -> params
    prefill_chunk(params, tokens, cache, slot, start, last_idx)
                                                      -> (logits, cache)
    decode(params, token, cache, keeps=, decode_kernel=)
                                                      -> (logits, cache)
    init_cache(batch, max_len, device)                -> zeroed dense cache

SSM (:class:`SSMModel`, Mamba2):

    init(generator=None, device=None)                 -> params
    prefill(params, batch)                            -> (last-token logits, cache)
    decode(params, token, cache)                      -> (logits, cache)
    init_cache(batch, max_len=None, device=None)      -> zeroed decode cache

Hybrid (:class:`HybridModel`, Zamba2): the SSM model's methods; its decode
cache holds one dense KV cache per shared-block call, which
:func:`prepare_decode_cache` pads to the decode length after prefill.

``init`` draws from ``generator`` onto its device when one is given;
otherwise from a generator seeded 0 on ``resolve_device(device)``: CUDA
unless the caller asks for the CPU, and an error when no GPU is present.
A ``device`` given beside a ``generator`` must be the generator's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T


def _generator(generator, device) -> torch.Generator:
    if generator is None:
        return torch.Generator(device=resolve_device(device)).manual_seed(0)
    if device is not None:
        want, have = torch.device(device), generator.device
        if want.type != have.type or want.index not in (None, have.index):
            raise ValueError(f"device {device!r} differs from the generator's "
                             f"device {have}")
    return generator


class Model(torch.nn.Module):
    """The dense decoder-only LM.  ``forward`` is one decode step."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        return T.init_lm_params(self.cfg, _generator(generator, device))

    def prefill_chunk(self, params, tokens, cache, slot, start, last_idx):
        return T.lm_prefill_chunk(params, self.cfg, tokens, cache, slot,
                                  start, last_idx)

    def decode(self, params, token, cache, keeps=None, decode_kernel="fused"):
        return T.lm_decode(params, self.cfg, token, cache, keeps=keeps,
                           decode_kernel=decode_kernel)

    def init_cache(self, batch: int, max_len: int, device, dtype=None) -> dict:
        return T.init_decode_cache(self.cfg, batch, max_len, device, dtype)

    def forward(self, params, token, cache, keeps=None, decode_kernel="fused"):
        return self.decode(params, token, cache, keeps=keeps,
                           decode_kernel=decode_kernel)


class _StateModel(torch.nn.Module):
    """A family served by whole-prompt prefill and one-token decode, through
    its module-level functions (``init``, ``loss``, ``prefill``,
    ``decode``).  ``forward`` is one decode step.  Everything runs where
    its parameters (and the cache) lie."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        return self._init(self.cfg, _generator(generator, device))

    def loss(self, params, batch):
        return self._loss(params, self.cfg, batch)

    def prefill(self, params, batch):
        return self._prefill(params, self.cfg, batch)

    def decode(self, params, token, cache):
        return self._decode(params, self.cfg, token, cache)

    def forward(self, params, token, cache):
        return self.decode(params, token, cache)


class SSMModel(_StateModel):
    """The Mamba2 LM."""

    _init = staticmethod(H.init_ssm_lm_params)
    _loss = staticmethod(H.ssm_lm_loss)
    _prefill = staticmethod(H.ssm_lm_prefill)
    _decode = staticmethod(H.ssm_lm_decode)

    def init_cache(self, batch: int, max_len=None, device=None, dtype=None) -> dict:
        """``max_len`` is accepted for the reference's call shape; the
        state is O(1) in the context length."""
        return H.init_ssm_lm_cache(self.cfg, batch, resolve_device(device), dtype)


class HybridModel(_StateModel):
    """The Zamba2 LM (Mamba2 layers and a shared attention block)."""

    _init = staticmethod(H.init_hybrid_params)
    _loss = staticmethod(H.hybrid_loss)
    _prefill = staticmethod(H.hybrid_prefill)
    _decode = staticmethod(H.hybrid_decode)

    def init_cache(self, batch: int, max_len: int, device=None, dtype=None) -> dict:
        return H.init_hybrid_cache(self.cfg, batch, max_len, resolve_device(device), dtype)


def prepare_decode_cache(cfg: ModelConfig, cache: dict, max_len: int) -> dict:
    """A prefill cache made ready for ``decode`` up to ``max_len`` tokens of
    context: the hybrid's shared-block k/v padded with zero rows along the
    sequence to ``max_len`` (never cut); the SSM state as it is.  The dense
    family's ring conversion is not ported (its serving path builds its
    cache chunk by chunk)."""
    if cfg.family == "ssm":
        return cache
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"prepare_decode_cache for family {cfg.family!r} is not ported yet")
    out = dict(cache)
    for name in ("k", "v"):
        t = cache[name]
        pad = max_len - t.shape[2]
        if pad > 0:
            out[name] = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
    return out


def build_model(cfg: ModelConfig) -> Model | SSMModel | HybridModel:
    if cfg.family == "dense":
        return Model(cfg)
    if cfg.family == "ssm":
        return SSMModel(cfg)
    if cfg.family == "hybrid":
        return HybridModel(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: the MoE, enc-dec and VLM "
        f"families come with the 'other model families' slice (ROADMAP queue "
        f"1)"
    )
