"""tinyllama-1.1b — dense llama2-arch, 22L d_model=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000.  [arXiv:2401.02385]

The sliding-window variant ``tinyllama-1.1b-swa`` (window=4096) is
registered beside it, as in the JAX package: its decode cache is
O(window), so it may run the ``long_500k`` decode shape.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="tinyllama-1.1b", arch_type="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
        d_ff=5632, vocab_size=32000,
        rope_theta=10_000.0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="tinyllama-1.1b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
    )


def config_swa() -> TransformerConfig:
    return dataclasses.replace(config(), name="tinyllama-1.1b-swa",
                               window=4096, global_attn_layers=())


def reduced_swa() -> TransformerConfig:
    return dataclasses.replace(reduced(), name="tinyllama-1.1b-swa-smoke",
                               window=64, global_attn_layers=())


register_arch("tinyllama-1.1b")((config, reduced))
register_arch("tinyllama-1.1b-swa")((config_swa, reduced_swa))
