"""Arch configs of the port (the counterpart of ``repro/configs``): the
JAX package's whole zoo — the dense models (qwen1.5-0.5b, qwen2-1.5b,
qwen3-32b, tinyllama-1.1b and its sliding-window variant), the MoE +
MLA models (deepseek-v2-lite-16b, deepseek-v3-671b with multi-token
prediction), the SSM, the hybrid, and the VLM (internvl2-1b) and audio
(musicgen-medium) backbones — each with its exact hyperparameters and
``reduced()`` smoke variant; ``with_peft`` adds LoRA adapters."""
from repro_torch.configs.common import (  # noqa: F401
    ARCHS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_reduced,
    list_archs,
    param_count,
    register_arch,
    with_peft,
)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_lite,
    deepseek_v3,
    hymba_15b,
    internvl2_1b,
    mamba2_13b,
    musicgen_medium,
    qwen15_05b,
    qwen2_15b,
    qwen3_32b,
    tinyllama_11b,
)
