"""Step functions of the port: train, prefill and serve."""

from repro_torch.launch.steps import (  # noqa: F401
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
