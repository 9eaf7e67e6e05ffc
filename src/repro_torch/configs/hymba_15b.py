"""hymba-1.5b — hybrid, 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads in every
block (outputs averaged), sliding-window attention with 3 global-attn
layers (first / middle / last).  [arXiv:2411.13676]
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="hymba-1.5b", arch_type="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001,
        window=1024, global_attn_layers=(0, 15, 31),
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_n_groups=1,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="hymba-1.5b-smoke", arch_type="hybrid",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
        window=32, global_attn_layers=(0,),
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_n_groups=1,
        ssm_chunk=32,
    )


register_arch("hymba-1.5b")((config, reduced))
