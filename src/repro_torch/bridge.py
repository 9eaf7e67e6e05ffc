"""Carry parameters between the JAX package and the port.

The port keeps the JAX package's parameter layout — the same dict keys,
HWIO conv weights, ``(d_in, d_out)`` fc weights — so a conversion is a
copy, and the flat buffers of the two packages line up element for
element.  The JAX side hands its params over as numpy
(``jax.tree.map(np.asarray, params)``); bf16 arrives as ``ml_dtypes``'
bfloat16 and is carried through its bit pattern.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device

Pytree = Any


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_numpy(tree: Pytree, device: Device = "cpu") -> Pytree:
    """Nested dict of numpy arrays → the port's params on ``device``."""
    return tm.tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Pytree) -> Pytree:
    """The port's params → nested dict of numpy arrays."""
    return tm.tree_map(_to_numpy, tree)
