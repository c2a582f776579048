"""AdamW over nested parameter trees (port of the reference's
``optim/adamw.py``): float32 first and second moments whatever the
parameter dtype, the update arithmetic in float32 and cast back to the
parameter's dtype (a bf16 parameter keeps its master copy implicitly),
decoupled weight decay, global-norm clipping, linear warmup then cosine
decay.  Functions of (grads, state, params) that return new trees, as the
reference's, under ``torch.no_grad``; the tensors stay on their device."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.optim.grad_utils import clip_by_global_norm
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine to ``min_lr_frac`` x lr: float32, from an
    integer step (a tensor or an int)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params) -> dict:
    """{'m', 'v': float32 zeros shaped like the params, 'step': int32 0} on
    the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics {'grad_norm', 'lr'}): the
    gradients in float32, clipped to ``clip_norm`` by their global norm,
    then one AdamW step with bias correction at the new step count."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32)
        new_p.append(p32.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    new_state = {"m": unflatten(params, new_m), "v": unflatten(params, new_v), "step": step}
    return unflatten(params, new_p), new_state, {"grad_norm": gnorm, "lr": lr}
