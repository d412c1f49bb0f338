"""Architecture registry. The port serves the dense ``smollm-135m``, the
SSM ``mamba2-370m`` and the hybrid ``zamba2-2.7b``; the other
architectures arrive with their families (ROADMAP §1 item 10)."""
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
from repro_torch.configs import mamba2_370m, smollm_135m, zamba2_2p7b  # noqa: F401,E402
