"""Step functions: prefill and serve (port of the reference's
``launch/steps.py``; its ``make_train_step`` comes with the training
slice).

They run eagerly where the parameters and the inputs lie; nothing moves
data between devices.  Greedy here; the serving engine composes decode
with the sampler.
"""

from __future__ import annotations

import torch


def make_prefill_step(model):
    """(params, batch) -> (last-token greedy token (B,) int32, cache)."""

    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(model):
    """(params, token, cache) -> (next token (B,) int32, cache): one greedy
    decode step."""

    def serve_step(params, token, cache):
        logits, cache = model.decode(params, token, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
