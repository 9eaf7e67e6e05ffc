"""qwen1.5-0.5b — dense, 24L d_model=1024 16H (kv=16, MHA) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-0.5b", arch_type="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=2816, vocab_size=151936,
        qkv_bias=True, rope_theta=10_000.0, tie_embeddings=True,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-0.5b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    )


register_arch("qwen1.5-0.5b")((config, reduced))
