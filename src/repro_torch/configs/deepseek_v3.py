"""deepseek-v3-671b — MoE, 61L d_model=7168 128H d_ff_expert=2048
vocab=129280; MLA (kv_lora=512, q_lora=1536); 1 shared + 256 routed,
top-8, sigmoid router; MTP depth-1; first 3 layers dense (d_ff=18432).
[arXiv:2412.19437]
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v3-671b", arch_type="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,                      # dense-FFN prefix layers
        vocab_size=129280,
        attention="mla", kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=256, top_k=8, n_shared_experts=1,
        d_ff_expert=2048, d_ff_shared=2048, n_dense_layers=3,
        router_scoring="sigmoid", capacity_factor=1.25, aux_loss_coef=0.0001,
        mtp=True, mtp_loss_weight=0.3,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v3-smoke", arch_type="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512,
        attention="mla", kv_lora_rank=64, q_lora_rank=96,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        n_experts=4, top_k=2, n_shared_experts=1,
        d_ff_expert=128, d_ff_shared=128, n_dense_layers=1,
        router_scoring="sigmoid", mtp=True,
    )


register_arch("deepseek-v3-671b")((config, reduced))
