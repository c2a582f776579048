"""Gradient utilities (port of the reference's ``optim/grad_utils.py``):
global-norm clipping, micro-batch gradient accumulation, and error-feedback
int8 gradient compression.  Trees are nested dicts of tensors, walked in
the reference's leaf order (:mod:`repro_torch.tree`)."""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for leaf in leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(tree x min(1, max_norm / max(norm, 1e-12)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by torch autograd; the
    gradients in each parameter's dtype, as ``jax.value_and_grad`` gives
    them.  ``params`` is left as it is (its leaves are differentiated
    through detached aliases)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def accumulate_grads(loss_fn, params, batch, n_micro: int):
    """Mean loss and gradients over ``n_micro`` micro-batches (each batch
    leaf split along its first axis, which n_micro must divide): each
    micro-batch's loss and gradients summed in float32, then both scaled
    by 1 / n_micro, as the reference's scan does.  One micro-batch returns
    its loss and gradients as they are."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    for leaf in leaves(batch):
        if leaf.shape[0] % n_micro:
            raise ValueError(f"batch {leaf.shape[0]} % n_micro {n_micro} != 0")
    loss_sum, g_sum = None, None
    for i in range(n_micro):
        micro = tree_map(lambda x: x.reshape(n_micro, x.shape[0] // n_micro,
                                             *x.shape[1:])[i], batch)
        loss, grads = value_and_grad(loss_fn, params, micro)
        loss = loss.float()
        grads = tree_map(lambda g: g.float(), grads)
        if g_sum is None:
            loss_sum, g_sum = loss, grads
        else:
            loss_sum = loss_sum + loss
            g_sum = tree_map(torch.add, g_sum, grads)
    inv = 1.0 / n_micro
    return loss_sum * inv, tree_map(lambda g: g * inv, g_sum)


# ---------------------------------------------------------------------------
# Error-feedback int8 gradient compression
# ---------------------------------------------------------------------------


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """g + err quantised to int8 with one per-tensor scale: (q, scale,
    new_err); the residual carries to the next step (EF-SGD)."""
    target = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(target)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.float() * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads, err_tree):
    """:func:`compress_int8` over a tree: (q tree, scale tree, new err
    tree)."""
    out = [compress_int8(g, e) for g, e in zip(leaves(grads), leaves(err_tree))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
