"""Arch configs the port serves (the counterpart of ``repro/configs``):
one dense, one SSM and one hybrid model of the JAX package's zoo, with
its exact hyperparameters and ``reduced()`` smoke variants.  The rest of
the zoo (MoE, MLA, VLM and audio backbones) waits for ROADMAP M12."""
from repro_torch.configs.common import (  # noqa: F401
    ARCHS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_reduced,
    list_archs,
    param_count,
    register_arch,
)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    hymba_15b,
    mamba2_13b,
    qwen15_05b,
)
