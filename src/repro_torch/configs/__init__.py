"""Arch configs of the port (the counterpart of ``repro/configs``): the
JAX package's whole zoo — the dense models (qwen1.5-0.5b, qwen2-1.5b,
qwen3-32b, tinyllama-1.1b and its sliding-window variant), the MoE +
MLA models (deepseek-v2-lite-16b, deepseek-v3-671b with multi-token
prediction), the SSM, the hybrid, and the VLM (internvl2-1b) and audio
(musicgen-medium) backbones — each with its exact hyperparameters and
``reduced()`` smoke variant; ``with_peft`` adds LoRA adapters.

``long_500k`` eligibility (sub-quadratic decode): mamba2-1.3b,
hymba-1.5b, tinyllama-1.1b-swa."""
from repro_torch.configs.common import (  # noqa: F401
    ARCHS,
    SHAPES,
    ShapeSpec,
    active_param_count,
    batch_specs,
    get_config,
    get_reduced,
    list_archs,
    param_count,
    params_specs,
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

ASSIGNED = (
    "qwen3-32b", "qwen1.5-0.5b", "deepseek-v2-lite-16b", "internvl2-1b",
    "qwen2-1.5b", "hymba-1.5b", "deepseek-v3-671b", "mamba2-1.3b",
    "musicgen-medium", "tinyllama-1.1b",
)

# archs that may run the long_500k decode shape (sub-quadratic decode)
LONG_CONTEXT_OK = ("mamba2-1.3b", "hymba-1.5b", "tinyllama-1.1b-swa")


def shape_applicable(arch: str, shape: str) -> bool:
    """True if (arch, shape) is a runnable pair."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True
