"""musicgen-medium — audio, 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens, 4 codebooks (delay
pattern), 4 parallel output heads.  [arXiv:2306.05284]

As in the JAX package, the EnCodec frontend is a STUB:
the caller supplies precomputed frame embeddings (the sum of the 4
codebook embeddings, as MusicGen feeds its decoder); this config is the
transformer that consumes them (input_mode='embeddings') and predicts
all 4 codebooks per frame.  MusicGen's non-gated GELU FFN is mapped to
this codebase's SwiGLU at equal d_ff (hardware-equivalent GEMM shapes).
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="musicgen-medium", arch_type="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048,
        input_mode="embeddings", n_codebooks=4,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="musicgen-smoke", arch_type="audio",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=128,
        input_mode="embeddings", n_codebooks=4,
    )


register_arch("musicgen-medium")((config, reduced))
