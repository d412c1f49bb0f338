"""Architecture registry: one module per architecture, as the JAX
package's. The port serves all ten: the dense ``smollm-135m``,
``stablelm-3b`` (int8 KV), ``phi3-medium-14b`` and ``internlm2-20b``, the
MoE ``granite-moe-1b-a400m`` and ``dbrx-132b``, the vlm ``internvl2-2b``,
the audio ``musicgen-large`` (int8 KV), the SSM ``mamba2-370m`` and the
hybrid ``zamba2-2.7b``."""
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
    dbrx_132b,
    granite_moe_1b,
    internlm2_20b,
    internvl2_2b,
    mamba2_370m,
    musicgen_large,
    phi3_medium_14b,
    smollm_135m,
    stablelm_3b,
    zamba2_2p7b,
)

ALL_ARCHS = list_configs()
