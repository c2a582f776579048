"""Carry the reference's JAX parameters (or any JAX pytree of arrays, such
as a decode cache or an AdamW state) across to the port, bit-exactly."""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # a NumPy bf16 extension array: read its bits through a 16-bit
        # view, so the port never imports that extension package
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_params, device) -> dict:
    """The JAX parameter pytree, as nested dicts of NumPy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), -> the same nested dict
    of torch tensors on ``device``, bit for bit: bf16 and float32 leaves
    alike, stacked layer axes (the reference's ``vmap``/``scan`` layout)
    kept as they are."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    return _tensor(np.asarray(np_params), device)


def opt_state_from_jax(np_state, device) -> dict:
    """The reference's AdamW state {'m', 'v': trees of float32, 'step':
    int32}, as NumPy (``jax.tree_util.tree_map(np.asarray, state)``) -> the
    port's (:func:`repro_torch.optim.adamw_init`'s layout) on ``device``,
    bit for bit, so that both sides can start from the same optimiser
    state."""
    out = {"m": params_from_jax(np_state["m"], device),
           "v": params_from_jax(np_state["v"], device),
           "step": torch.tensor(int(np.asarray(np_state["step"])), dtype=torch.int32,
                                device=device)}
    return out
