from repro_torch.configs.base import (  # noqa: F401
    AudioConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VisionConfig,
    get_config,
    register,
    registry,
)
