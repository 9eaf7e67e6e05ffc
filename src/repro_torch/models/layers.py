"""Initializers (the counterpart of ``repro/models/layers.py``'s
``he_normal`` and ``normal_init``), drawing from a ``torch.Generator``.

The draws differ from ``jax.random``'s for the same seed; tests that
compare the two packages carry the JAX package's weights across with
``repro_torch.bridge.params_from_numpy``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def he_normal(gen: torch.Generator, shape: Sequence[int],
              dtype=torch.float32, fan_in: Optional[int] = None
              ) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    std = math.sqrt(2.0 / max(fan, 1))
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def normal_init(gen: torch.Generator, shape: Sequence[int], std=0.02,
                dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)
