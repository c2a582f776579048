"""Mixture-of-Experts layer (port of the reference's ``models/moe.py``):
top-k routing with sort-based dispatch into fixed-capacity expert buffers.

1. router softmax (float32) -> top-k (expert, gate) per token, ties to
   the lower expert id, the gates renormalised over the k;
2. the (token, k) assignments flattened and stably sorted by expert id;
3. rank within the expert from the exclusive cumsum of expert counts;
4. assignments ranked at or past the capacity are dropped;
5. the survivors scattered into an (E, C, d) buffer, the expert SwiGLU as
   batched products over the expert axis, gathered back weighted by the
   gate and added up per token in bf16, by ascending expert id.

Dispatch is per batch row (the reference ``vmap``s it): each row sorts its
own tokens and has its own capacity.  Here the rows run together, their
buffers side by side, so the expert products are one batched product per
weight over the expert axis, each expert's rows from every batch row.
Products are bf16 and rounded where the reference's compiled graph rounds
them (the SwiGLU as :func:`~repro_torch.models.layers.mlp_apply` writes it).
The expert products are plain ``torch.matmul`` (the reference runs jnp
einsums here, no kernel).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import he_init, mlp_apply


def moe_params(generator: torch.Generator, cfg, dtype) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": he_init((d, e), generator, dtype),
        "w_gate": he_init((e, d, ff), generator, dtype, fan_in=d),
        "w_in": he_init((e, d, ff), generator, dtype, fan_in=d),
        "w_out": he_init((e, ff, d), generator, dtype, fan_in=ff),
    }
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": he_init((d, sf), generator, dtype),
            "w_in": he_init((d, sf), generator, dtype),
            "w_out": he_init((sf, d), generator, dtype, fan_in=sf),
        }
    return p


def capacity(n_tokens: int, cfg, inference: bool = False) -> int:
    """Slots an expert holds per batch row.  Training: the GShard capacity
    factor.  Inference: dropless (an expert can take at most one slot per
    token) while n_tokens x experts <= 2^22, so serving results do not
    depend on batch composition; past that, 2x the mean load."""
    if inference:
        if n_tokens * cfg.n_experts <= (1 << 22):
            return n_tokens
        return max(8, int(n_tokens * cfg.moe_top_k / cfg.n_experts * 2.0 + 0.999))
    ideal = n_tokens * cfg.moe_top_k / cfg.n_experts
    return max(8, int(ideal * cfg.capacity_factor + 0.999))


def top_k_routes(probs: torch.Tensor, k: int):
    """(gate, expert): each token's k largest router probabilities and
    their experts, in lax.top_k's order: among equal probabilities (an
    exact tie of bf16 router logits) the lower expert id first
    (torch.topk leaves ties open)."""
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[..., :k], expert[..., :k]


def moe_apply(params: dict, x: torch.Tensor, cfg, inference: bool = False):
    """x (B, S, d) -> ((B, S, d), aux): aux is the Switch-style load-balance
    loss E * sum_e f_e p_e, float32, averaged over the batch rows."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    c = capacity(s, cfg, inference)
    n = s * k
    dev = x.device
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)  # router fp32
    gate, expert = top_k_routes(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(1, order)
    t_sorted = torch.div(order, k, rounding_mode="floor")  # flat index // k
    g_sorted = gate.reshape(b, n).gather(1, order)

    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(n, device=dev) - starts.gather(1, e_sorted)
    keep = rank < c
    # dropped assignments go to an overflow row past the buffers
    slot = torch.where(keep, e_sorted * c + rank, torch.full_like(rank, e * c))

    picked = x.gather(1, t_sorted[..., None].expand(b, n, d)) * keep[..., None].to(x.dtype)
    buf = x.new_zeros((b, e * c + 1, d))
    buf.scatter_(1, slot[..., None].expand(b, n, d), picked)
    # (B, E*C, d) -> (E, B*C, d): each expert's rows of every batch row
    h_in = buf[:, :e * c].reshape(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)
    g = torch.matmul(h_in, params["w_gate"])
    # silu as the reference's XLA expands it for bf16, each op rounded
    act = g * (1 / (1 + torch.exp(-g))) * torch.matmul(h_in, params["w_in"])
    y_exp = torch.matmul(act, params["w_out"])  # (E, B*C, d)
    y_rows = torch.cat([y_exp.reshape(e, b, c, d).transpose(0, 1).reshape(b, e * c, d),
                        x.new_zeros((b, 1, d))], dim=1)
    y_tok = (y_rows.gather(1, slot[..., None].expand(b, n, d))
             * (g_sorted * keep).to(x.dtype)[..., None])
    # the reference's bf16 scatter-add applies a token's k terms in the
    # sorted order, by expert id, each add rounded to bf16 (XLA's order; a
    # float32 sum or another order rounds apart from k = 3 on)
    y_by_token = torch.empty_like(y_tok).scatter_(
        1, order[..., None].expand(b, n, d), y_tok).reshape(b, s, k, d)
    by_expert = torch.argsort(expert, dim=-1)
    y_by_token = y_by_token.gather(2, by_expert[..., None].expand(b, s, k, d))
    out = y_by_token[:, :, 0]
    for j in range(1, k):
        out = out + y_by_token[:, :, j]

    frac = counts.float() / n
    aux = e * (frac * probs.mean(dim=1)).sum(dim=-1)
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], x, "swiglu")
    return out, aux.mean()
