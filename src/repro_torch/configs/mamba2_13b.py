"""mamba2-1.3b — attention-free SSM (SSD), 48L d_model=2048 vocab=50280,
ssm_state=128, head_dim=64, expand=2, groups=1.  [arXiv:2405.21060]
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="mamba2-1.3b", arch_type="ssm",
        n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280, attention="none",
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_n_groups=1,
        ssm_chunk=128,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="mamba2-smoke", arch_type="ssm",
        n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512, attention="none",
        ssm_state=32, ssm_head_dim=32, ssm_expand=2, ssm_n_groups=1,
        ssm_chunk=32,
    )


register_arch("mamba2-1.3b")((config, reduced))
