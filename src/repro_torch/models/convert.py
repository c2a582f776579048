"""Carry the reference's JAX parameters (or any JAX pytree of arrays, such
as a decode cache) across to the port, bit-exactly."""

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
