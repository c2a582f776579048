"""Step functions of the port: prefill and serve (the training step comes
with the training slice)."""

from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: F401
