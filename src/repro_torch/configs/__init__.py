from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ModelConfig,
    get_config,
)
