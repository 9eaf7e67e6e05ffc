"""internvl2-1b — VLM, 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 (Qwen2-0.5B language backbone).  [arXiv:2404.16821]

As in the JAX package, the InternViT-300M vision frontend is a
STUB: the caller supplies precomputed patch embeddings (256 tokens,
d_model-sized, post-projector) and this config implements the decoder
that consumes them (input_mode='vlm').
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="internvl2-1b", arch_type="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151655,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
        input_mode="vlm", n_prefix_tokens=256,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="internvl2-1b-smoke", arch_type="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, qkv_bias=True, tie_embeddings=True,
        input_mode="vlm", n_prefix_tokens=16,
    )


register_arch("internvl2-1b")((config, reduced))
