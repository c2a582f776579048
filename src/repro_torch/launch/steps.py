"""Step functions: train, prefill and serve (port of the reference's
``launch/steps.py``).

They run eagerly where the parameters and the inputs lie; nothing moves
data between devices.  Greedy here; the serving engine composes decode
with the sampler.  Every family's model has ``prefill`` and ``decode``
(dense, MoE and VLM through the transformer's whole-prompt prefill, SSM,
hybrid and enc-dec through their own), so both serving steps run all six;
the train step runs the families whose ``loss`` is ported (dense, MoE,
VLM, enc-dec).
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_utils import accumulate_grads


def make_train_step(model, opt_cfg: AdamWConfig, n_micro: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the mean
    loss and gradients over ``n_micro`` micro-batches, then one AdamW
    update; metrics {'grad_norm', 'lr', 'loss'}."""

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(model.loss, params, batch, n_micro)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


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
