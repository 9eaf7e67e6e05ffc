"""Arch configs of the port (the counterpart of ``repro/configs``): the
JAX package's dense models (qwen1.5-0.5b, qwen2-1.5b, qwen3-32b,
tinyllama-1.1b and its sliding-window variant), its SSM and its hybrid
model, each with its exact hyperparameters and ``reduced()`` smoke
variant; ``with_peft`` adds LoRA adapters.  The rest of the zoo (MoE,
MLA, VLM and audio backbones) waits for ROADMAP M12b."""
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
    hymba_15b,
    mamba2_13b,
    qwen15_05b,
    qwen2_15b,
    qwen3_32b,
    tinyllama_11b,
)
