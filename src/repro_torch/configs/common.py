"""Config machinery (the counterpart of ``repro/configs/common.py``): the
arch registry and the assigned input shapes.

The port keeps its own copy: it imports nothing of the JAX package.
Each arch module registers a ``(config, reduced)`` pair of factories;
``param_count`` counts a config's parameters on the ``meta`` device, so
nothing is allocated; ``with_peft`` adds LoRA adapters to a config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.models.transformer import TransformerConfig, init_lm
from repro_torch.utils.registry import Registry
from repro_torch.utils.tree_math import tree_leaves

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


def param_count(cfg: TransformerConfig) -> int:
    """Every leaf's elements, LoRA adapters included."""
    params = init_lm(cfg, device="meta")
    return sum(math.prod(t.shape) for t in tree_leaves(params))
