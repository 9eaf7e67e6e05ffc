"""deepseek-v2-lite-16b — MoE, 27L d_model=2048 16H d_ff_expert=1408
vocab=102400; MLA kv_lora=512; 2 shared + 64 routed experts, top-6.
[arXiv:2405.04434]

As the JAX package's config: the model card's 64 routed experts (160
is the full DeepSeek-V2's figure), 2 shared, top-6, first layer
dense-FFN (d_ff=10944), MLA without q-LoRA.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import register_arch
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-lite-16b", arch_type="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,                      # dense-FFN prefix layer
        vocab_size=102400,
        attention="mla", kv_lora_rank=512, q_lora_rank=None,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=64, top_k=6, n_shared_experts=2,
        d_ff_expert=1408, d_ff_shared=2816, n_dense_layers=1,
        router_scoring="softmax", capacity_factor=1.25, aux_loss_coef=0.001,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-lite-smoke", arch_type="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512,
        attention="mla", kv_lora_rank=64, q_lora_rank=None,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        n_experts=4, top_k=2, n_shared_experts=1,
        d_ff_expert=128, d_ff_shared=128, n_dense_layers=1,
    )


register_arch("deepseek-v2-lite-16b")((config, reduced))
