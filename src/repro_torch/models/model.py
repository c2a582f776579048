"""Model API of the port: the dense branch of the reference's
``models/model.py::build_model``.

``build_model(cfg)`` returns a :class:`Model` whose methods keep the
reference's call shapes (parameters are passed in, as in JAX, so the
serving stack and the parity tests hand the same nested dict around):

    init(generator)                                   -> params
    prefill_chunk(params, tokens, cache, slot, start, last_idx)
                                                      -> (logits, cache)
    decode(params, token, cache, keeps=, decode_kernel=)
                                                      -> (logits, cache)
    init_cache(batch, max_len, device)                -> zeroed dense cache
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


class Model(torch.nn.Module):
    """The dense decoder-only LM.  ``forward`` is one decode step."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        return T.init_lm_params(self.cfg, generator)

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


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the MoE, SSM, hybrid, "
            f"enc-dec and VLM families come with the 'other model families' "
            f"slice (ROADMAP queue 1 item 8)"
        )
    return Model(cfg)
