"""qwen2-1.5b — dense, 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias.  [arXiv:2407.10671]"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", arch_type="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    )


register_arch("qwen2-1.5b")((config, reduced))
