"""Assigned-architecture configs (``--arch <id>``)."""
from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ARCH_REGISTRY,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SHAPE_BY_NAME,
    ShapeSpec,
    SSMConfig,
    get_arch,
    register,
)

# importing registers each arch
from repro_torch.configs import (  # noqa: F401
    codeqwen1_5_7b,
    granite_moe_3b_a800m,
    internvl2_1b,
    jamba_1_5_large_398b,
    llama3_2_3b,
    minicpm3_4b,
    mixtral_8x7b,
    rwkv6_3b,
    tinyllama_1_1b,
    whisper_small,
)

ALL_ARCHS = tuple(sorted(ARCH_REGISTRY))
