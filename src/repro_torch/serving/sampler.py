"""Token sampler: greedy / temperature / top-k.

Greedy is ``argmax``, which returns the first maximum in torch as in jnp,
so greedy tokens match the reference exactly.  With temperature > 0, row
``i`` draws from a ``torch.Generator`` seeded from ``(rng_seed, rid,
draw)``: a request's tokens depend only on its own stream and position,
never on batch composition.  Those bits are NOT the reference's JAX
``fold_in`` streams, so parity with the reference holds for greedy
sampling only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = full softmax


def _generator(seed: int, rid: int, draw: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, rid, draw]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def token_probs(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) float32 -> the distribution a temperature draw samples
    from (temperature > 0): the softmax of logits / temperature with every
    logit below the k-th largest masked, as the reference's categorical
    draw over its masked logits."""
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    return torch.softmax(logits, dim=-1)


def sample(logits: torch.Tensor, cfg: SamplerConfig, seed: int = 0,
           rid: int = 0, draw: int = 0) -> torch.Tensor:
    """logits (B, V) float32 -> tokens (B,) int64 (one stream for every row)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    g = _generator(seed, rid, draw, logits.device)
    return torch.multinomial(token_probs(logits, cfg), 1, generator=g)[:, 0]


def sample_slots(seeds, rids, draws, logits: torch.Tensor,
                 cfg: SamplerConfig) -> torch.Tensor:
    """Per-slot streams for continuous batching: row ``i`` draws token
    number ``draws[i]`` of stream ``(seeds[i], rids[i])``."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.cat([
        sample(logits[i:i + 1], cfg, int(seeds[i]), int(rids[i]), int(draws[i]))
        for i in range(logits.shape[0])
    ])
