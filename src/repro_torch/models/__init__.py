"""Models of the port (the dense transformer family so far)."""

from repro_torch.models.model import Model, build_model  # noqa: F401
