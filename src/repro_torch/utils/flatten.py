"""FlatView — pack a tree of tensors into contiguous per-dtype 1-D buffers.

The counterpart of ``repro/utils/flatten.py:FlatView`` (without the
trainable-slice ``filter``).  The contract is the same:

  view = FlatView.of(tree)          # shapes/dtypes only
  bufs = view.flatten(tree)         # {dtype_name: (total,) 1-D buffer}
  tree == view.unflatten(bufs)      # exact round-trip, any nesting

Leaves are taken in jax.tree_util order (dict keys sorted, see
``tree_math.tree_flatten``) and grouped by dtype name ("float32",
"bfloat16", ...) in first-seen order; each owns a static ``[offset,
offset + size)`` slice of its buffer, so a port buffer equals the JAX
package's buffer element for element.

``unflatten`` returns VIEWS into the buffers.  When a buffer requires
grad, the views come from one autograd node per bucket whose backward
concatenates the leaf gradients into a single packed gradient (pad lanes
zero) — the counterpart of the JAX package differentiating with respect
to the flat buffers, so the fused step tail consumes the gradient with
no per-step pack.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.tree_math import tree_flatten, tree_unflatten

Pytree = Any


def dtype_name(dtype) -> str:
    """Canonical dtype name for a torch or numpy dtype ("float32")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return dtype.name


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's static slice of its dtype buffer."""
    buffer: str                 # canonical dtype name, e.g. "float32"
    offset: int                 # element offset into the buffer
    size: int                   # number of elements (1 for scalar leaves)
    shape: Tuple[int, ...]      # original leaf shape


class _LeafViews(torch.autograd.Function):
    """Leaf views of one bucket whose backward packs the leaf gradients
    into ONE buffer-shaped gradient (a single concatenate)."""

    @staticmethod
    def forward(ctx, buf, slots):
        ctx.slots = slots
        ctx.n = buf.shape[-1]
        return tuple(buf[s.offset:s.offset + s.size].view(s.shape)
                     for s in slots)

    @staticmethod
    def backward(ctx, *grads):
        parts = [g.reshape(-1) for g in grads]
        end = ctx.slots[-1].offset + ctx.slots[-1].size
        if ctx.n > end:                 # grid pad lanes: zero gradient
            parts.append(grads[0].new_zeros(ctx.n - end))
        return torch.cat(parts), None


@dataclasses.dataclass(frozen=True)
class FlatView:
    """Static packing plan for one tree structure (see module doc)."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]

    @classmethod
    def of(cls, tree: Pytree) -> "FlatView":
        """Build a view from shapes/dtypes only (torch tensors or numpy
        arrays)."""
        leaves, treedef = tree_flatten(tree)
        sizes: Dict[str, int] = {}
        slots = []
        for leaf in leaves:
            name = dtype_name(leaf.dtype)
            size = int(math.prod(leaf.shape))
            off = sizes.get(name, 0)
            slots.append(LeafSlot(buffer=name, offset=off, size=size,
                                  shape=tuple(leaf.shape)))
            sizes[name] = off + size
        return cls(treedef=treedef, slots=tuple(slots))

    @property
    def buffer_sizes(self) -> Dict[str, int]:
        """Total elements per dtype buffer, first-seen order."""
        sizes: Dict[str, int] = {}
        for s in self.slots:
            sizes[s.buffer] = s.offset + s.size
        return sizes

    @property
    def total_size(self) -> int:
        return sum(self.buffer_sizes.values())

    def _check(self, tree: Pytree) -> list:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure mismatch with this FlatView")
        return leaves

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack ``tree`` into ``{dtype_name: (total,) buffer}`` (a copy)."""
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            parts.setdefault(slot.buffer, []).append(leaf.reshape(-1))
        return {name: torch.cat(chunks) for name, chunks in parts.items()}

    def unflatten(self, bufs: Dict[str, torch.Tensor]) -> Pytree:
        """Inverse of :meth:`flatten`: leaves are views of ``bufs``
        (which may carry grid padding past the logical size)."""
        leaves = [None] * len(self.slots)
        for name in self.buffer_sizes:
            idx = [i for i, s in enumerate(self.slots) if s.buffer == name]
            buf = bufs[name]
            if buf.requires_grad and torch.is_grad_enabled():
                views = _LeafViews.apply(
                    buf, tuple(self.slots[i] for i in idx))
            else:
                views = [buf[self.slots[i].offset:self.slots[i].offset +
                             self.slots[i].size].view(self.slots[i].shape)
                         for i in idx]
            for i, v in zip(idx, views):
                leaves[i] = v
        return tree_unflatten(self.treedef, leaves)

    def flatten_stacked(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """Pack a tree whose leaves carry one shared leading axis K into
        ``{dtype_name: (K, total)}`` buffers."""
        parts: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, self._check(tree)):
            parts.setdefault(slot.buffer, []).append(
                leaf.reshape(leaf.shape[0], -1))
        return {name: torch.cat(chunks, dim=1)
                for name, chunks in parts.items()}

    def unflatten_stacked(self, bufs: Dict[str, torch.Tensor]) -> Pytree:
        """Inverse of :meth:`flatten_stacked` (views).  The empty tree
        round-trips to itself."""
        leaves = []
        for s in self.slots:
            buf = bufs[s.buffer]
            leaves.append(buf[:, s.offset:s.offset + s.size].reshape(
                (buf.shape[0],) + s.shape))
        return tree_unflatten(self.treedef, leaves)

    def zeros(self, dtype=None, device=None) -> Dict[str, torch.Tensor]:
        """Zero buffers with this view's sizes; ``dtype`` overrides the
        per-buffer dtype (e.g. an f32 accumulator over bf16 params)."""
        return {name: torch.zeros((size,), dtype=dtype or torch_dtype(name),
                                  device=device)
                for name, size in self.buffer_sizes.items()}
