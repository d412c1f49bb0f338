"""Architecture registry. The port serves the dense ``smollm-135m``,
``stablelm-3b`` (int8 KV), ``phi3-medium-14b`` and ``internlm2-20b``, the
SSM ``mamba2-370m`` and the hybrid ``zamba2-2.7b``; the MoE, vlm and audio
architectures arrive with their families (ROADMAP §1 item 10b)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    pad_to_multiple,
    register,
)

# Importing each module registers its config.
from repro_torch.configs import (  # noqa: F401,E402
    internlm2_20b,
    mamba2_370m,
    phi3_medium_14b,
    smollm_135m,
    stablelm_3b,
    zamba2_2p7b,
)
