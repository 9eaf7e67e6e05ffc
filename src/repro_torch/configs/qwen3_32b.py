"""qwen3-32b — dense, 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm, head_dim=128.  [hf:Qwen/Qwen3-8B family card,
scaled per assignment]"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-32b", arch_type="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab_size=151936,
        qk_norm=True, qkv_bias=False, rope_theta=1_000_000.0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-32b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, qk_norm=True,
    )


register_arch("qwen3-32b")((config, reduced))
