"""Config machinery (the counterpart of ``repro/configs/common.py``): the
arch registry and the assigned input shapes.

The port keeps its own copy: it imports nothing of the JAX package.
Each arch module registers a ``(config, reduced)`` pair of factories;
``param_count`` counts a config's parameters on the ``meta`` device, so
nothing is allocated; ``with_peft`` adds LoRA adapters to a config.
``params_specs`` and ``batch_specs`` describe a step's inputs as
``meta`` tensors (the analog of ``jax.ShapeDtypeStruct``), with the JAX
package's keys, shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.models.transformer import (TransformerConfig,
                                            init_decode_cache, init_lm)
from repro_torch.utils.registry import Registry
from repro_torch.utils.tree_math import tree_leaves, tree_paths

ARCHS: Registry = Registry("architecture")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def register_arch(name: str):
    """Register an arch module's (config, reduced) pair."""

    def deco(fns):
        ARCHS.register(name)(fns)
        return fns

    return deco


def get_config(name: str) -> TransformerConfig:
    return ARCHS.get(name)[0]()


def get_reduced(name: str) -> TransformerConfig:
    return ARCHS.get(name)[1]()


def list_archs():
    return ARCHS.names()


def with_peft(cfg: TransformerConfig, peft: Optional[str]
              ) -> TransformerConfig:
    """Apply a PEFT spec to an arch config: ``"lora:<r>"`` builds the
    model with rank-``r`` adapters on every attention and MLP projection,
    so the "lora" trainable filter has leaves to match.  ``None`` is the
    identity."""
    if peft is None:
        return cfg
    from repro_torch.fl.local import parse_peft
    _, rank = parse_peft(peft)
    return dataclasses.replace(cfg, lora_rank=rank)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: TransformerConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The model-input batch of one step as ``meta`` tensors.

    train   : full-sequence tokens + labels
    prefill : full-sequence tokens (the cache is built inside the step)
    decode  : ONE new token + the KV/SSM cache at seq_len + cache_len
    """
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32

    def text_batch(with_labels: bool):
        b = {"tokens": _spec((B, S), tok)}
        if with_labels:
            b["labels"] = _spec((B, S), tok)
        return b

    def vlm_batch(with_labels: bool):
        P = cfg.n_prefix_tokens
        b = {"patch_embeds": _spec((B, P, cfg.d_model), cfg.dtype),
             "tokens": _spec((B, S - P), tok)}
        if with_labels:
            b["labels"] = _spec((B, S - P), tok)
        return b

    def audio_batch(with_labels: bool):
        b = {"frame_embeds": _spec((B, S, cfg.d_model), cfg.dtype)}
        if with_labels:
            b["labels"] = _spec((B, S, cfg.n_codebooks)
                                if cfg.n_codebooks > 1 else (B, S), tok)
        return b

    build = {"tokens": text_batch, "vlm": vlm_batch,
             "embeddings": audio_batch}[cfg.input_mode]
    if shape.kind == "train":
        return build(True)
    if shape.kind == "prefill":
        return build(False)
    # decode: one token against a cache of size seq_len
    cache = init_decode_cache(cfg, B, S, device="meta")
    if cfg.input_mode == "embeddings":
        token = _spec((B, 1, cfg.d_model), cfg.dtype)
    else:
        token = _spec((B, 1), tok)
    return {"token": token, "cache": cache, "cache_len": _spec((), tok)}


def params_specs(cfg: TransformerConfig):
    """The parameter tree on the ``meta`` device: nothing is allocated."""
    return init_lm(cfg, device="meta")


def param_count(cfg: TransformerConfig) -> int:
    """Every leaf's elements, LoRA adapters included."""
    return sum(math.prod(t.shape) for t in tree_leaves(params_specs(cfg)))


def active_param_count(cfg: TransformerConfig) -> int:
    """Per-token active parameters: an MoE counts its top_k (and shared)
    experts only; the MODEL_FLOPS of the roofline are 6·N_active·D."""
    tree = params_specs(cfg)
    total = sum(math.prod(t.shape) for t in tree_leaves(tree))
    if not cfg.is_moe:
        return total
    experts = sum(math.prod(t.shape) for path, t in
                  zip(tree_paths(tree), tree_leaves(tree))
                  if "experts" in path)
    return int(total - experts * (1.0 - cfg.top_k / cfg.n_experts))
