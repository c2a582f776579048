"""Models of the port: the dense, SSM (Mamba2) and hybrid (Zamba2) families."""

from repro_torch.models.model import Model, build_model  # noqa: F401
