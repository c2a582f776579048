"""Model API of the port: the reference's ``models/model.py``
(``build_model`` over all six families, ``prepare_decode_cache``,
``text_len`` and ``demo_batch``).

``build_model(cfg)`` returns a model whose methods keep the reference's
call shapes (parameters are passed in, as in JAX, so the serving stack,
the step functions and the parity tests hand the same nested dict around).

Dense, MoE and VLM (:class:`Model`; a sliding-window config's cache is a
ring; a VLM batch carries ``'patches'``):

    init(generator=None, device=None)                 -> params
    loss(params, batch)                               -> scalar training loss
    prefill(params, batch)                            -> (last-token logits, cache)
    prefill_chunk(params, tokens, cache, slot, start, last_idx)
                                                      -> (logits, cache)
    decode(params, token, cache, keeps=, decode_kernel=)
                                                      -> (logits, cache)
    init_cache(batch, max_len, device)                -> zeroed dense cache

SSM (:class:`SSMModel`, Mamba2), hybrid (:class:`HybridModel`, Zamba2) and
enc-dec (:class:`EncDecModel`, Whisper; a batch carries ``'frames'``):

    init(generator=None, device=None)                 -> params
    loss(params, batch)                               -> scalar training loss
    prefill(params, batch)                            -> (last-token logits, cache)
    decode(params, token, cache)                      -> (logits, cache)
    init_cache(batch, max_len=None, device=None)      -> zeroed decode cache

``loss`` is the training loss, differentiable with torch autograd (the
flash kernel's backward on the card); the SSM and hybrid losses raise
until the SSD scan has a backward.

The hybrid's decode cache holds one dense KV cache per shared-block call
and the enc-dec's a self-attention cache per decoder layer; both write a
decode token's k/v in place, so :func:`prepare_decode_cache` pads a
prefill cache to the decode length first, as it does the dense one.

``init`` draws from ``generator`` onto its device when one is given;
otherwise from a generator seeded 0 on ``resolve_device(device)``: CUDA
unless the caller asks for the CPU, and an error when no GPU is present.
A ``device`` given beside a ``generator`` must be the generator's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import frontends
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
    """The decoder-only LM of the dense, MoE and VLM families.  ``forward``
    is one decode step."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        return T.init_lm_params(self.cfg, _generator(generator, device))

    def loss(self, params, batch):
        return T.lm_loss(params, self.cfg, batch)

    def prefill(self, params, batch):
        return T.lm_prefill(params, self.cfg, batch)

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


class EncDecModel(_StateModel):
    """The Whisper encoder-decoder LM."""

    _init = staticmethod(E.init_encdec_params)
    _loss = staticmethod(E.encdec_loss)
    _prefill = staticmethod(E.encdec_prefill)
    _decode = staticmethod(E.encdec_decode)

    def init_cache(self, batch: int, max_len: int, device=None, dtype=None) -> dict:
        return E.init_encdec_cache(self.cfg, batch, max_len, resolve_device(device), dtype)


def prepare_decode_cache(cfg: ModelConfig, cache: dict, max_len: int) -> dict:
    """A prefill cache made ready for ``decode`` up to ``max_len`` tokens of
    context: the dense, MoE and VLM families' k/v padded along the
    sequence, or a sliding-window config's ring built
    (:func:`~repro_torch.models.transformer.ring_cache_from_prefill`); the
    hybrid's shared-block k/v and the enc-dec's decoder self-attention k/v
    padded with zero rows along the sequence to ``max_len`` (never cut);
    the SSM state as it is."""
    if cfg.family in ("dense", "moe", "vlm"):
        return T.ring_cache_from_prefill(cache, cfg, max_len)
    if cfg.family == "ssm":
        return cache
    names = {"hybrid": ("k", "v"), "encdec": ("self_k", "self_v")}[cfg.family]
    out = dict(cache)
    for name in names:
        t = cache[name]
        pad = max_len - t.shape[2]
        if pad > 0:
            out[name] = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
    return out


def text_len(cfg: ModelConfig, cell) -> int:
    """Tokens the text stream contributes to a sequence of ``cell``
    positions (an int, or a shape cell with ``seq_len``; reference
    ``text_len``): a VLM budgets ``n_patches`` positions for image tokens,
    an enc-dec model ``enc_seq`` frames for the encoder."""
    seq_len = getattr(cell, "seq_len", cell)
    if cfg.family == "vlm":
        t = seq_len - cfg.n_patches
    elif cfg.family == "encdec":
        t = seq_len - cfg.enc_seq
    else:
        t = seq_len
    if t <= 0:
        raise ValueError(f"{cfg.name}: seq_len {seq_len} too short for the modality prefix")
    return t


def demo_batch(cfg: ModelConfig, generator: torch.Generator, batch: int, seq: int) -> dict:
    """A runnable batch {tokens, labels[, patches | frames]} drawn from
    ``generator`` on its device (reference ``demo_batch``): tokens uniform
    in [0, vocab), labels the tokens, the modality's unit-scale stand-in."""
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           dtype=torch.int64, device=generator.device).to(torch.int32)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["patches"] = frontends.fake_patches(generator, cfg, batch)
    elif cfg.family == "encdec":
        out["frames"] = frontends.fake_frames(generator, cfg, batch)
    return out


def build_model(cfg: ModelConfig) -> Model | SSMModel | HybridModel | EncDecModel:
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(cfg)
    if cfg.family == "ssm":
        return SSMModel(cfg)
    if cfg.family == "hybrid":
        return HybridModel(cfg)
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
