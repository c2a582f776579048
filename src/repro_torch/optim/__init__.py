"""Optimiser of the port: AdamW over nested parameter trees and the gradient
utilities (port of the reference's ``optim/``)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, schedule  # noqa: F401
from repro_torch.optim.grad_utils import (  # noqa: F401
    accumulate_grads,
    clip_by_global_norm,
    global_norm,
    value_and_grad,
)
