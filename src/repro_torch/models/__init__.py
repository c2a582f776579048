"""Models of the port: all six families of the reference (dense, MoE,
SSM, hybrid, VLM, enc-dec)."""

from repro_torch.models.model import Model, build_model  # noqa: F401
