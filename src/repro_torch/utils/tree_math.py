"""Pytree arithmetic over nested dicts of tensors.

The counterpart of ``repro/utils/tree_math.py``.  A tree is a nested
dict / list / tuple (NamedTuples included) with tensors at the leaves;
``None`` is an empty node.  Leaf order is the order
``jax.tree_util.tree_flatten`` uses — dict keys SORTED, sequences in
order — so a flat buffer packed from a port tree lines up element for
element with one packed by the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

Pytree = Any


def tree_flatten(tree: Pytree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in jax.tree_util order (sorted dict keys)."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(rec(t[k]) for k in keys))
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return ("namedtuple", type(t), tuple(rec(x) for x in t))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, None, tuple(rec(x) for x in t))
        if t is None:
            return ("none", None, ())
        leaves.append(t)
        return ("leaf", None, ())

    treedef = rec(tree)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves) -> Pytree:
    it = iter(leaves)

    def build(d):
        kind, meta, children = d
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(meta, children)}
        built = [build(c) for c in children]
        if kind == "namedtuple":
            return meta(*built)
        return built if kind == "list" else tuple(built)

    return build(treedef)


def tree_leaves(tree: Pytree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree structure mismatch in tree_map")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def scale(a: Pytree, s) -> Pytree:
    return tree_map(lambda x: x * s, a)


def add_scaled(a: Pytree, b: Pytree, s) -> Pytree:
    """a + s * b, per leaf (two rounded ops, as in the JAX package)."""
    return tree_map(lambda x, y: x + s * y, a, b)


def zeros_like(a: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, a)


def stacked_weighted_mean(stacked: Pytree, weights: torch.Tensor) -> Pytree:
    """Weighted mean over the leading client axis: leaves are (K, ...)."""
    w = weights / torch.sum(weights)

    def combine(leaf):
        wb = w.reshape((-1,) + (1,) * (leaf.ndim - 1)).to(leaf.dtype)
        return torch.sum(leaf * wb, dim=0)

    return tree_map(combine, stacked)


def squared_norm(a: Pytree) -> torch.Tensor:
    return sum(torch.dot(x.reshape(-1), x.reshape(-1)) for x in tree_leaves(a))


def norm(a: Pytree) -> torch.Tensor:
    return torch.sqrt(squared_norm(a))


def global_clip(a: Pytree, max_norm: float) -> Pytree:
    factor = torch.clamp(max_norm / (norm(a) + 1e-12), max=1.0)
    return scale(a, factor)


def count_params(a: Pytree) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(a))


def size_bytes(a: Pytree) -> int:
    return sum(int(math.prod(x.shape)) * x.element_size()
               for x in tree_leaves(a))
