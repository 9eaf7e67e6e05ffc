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
from typing import Any, Callable, List, Optional, Tuple

import torch

Pytree = Any


def tree_flatten(tree: Pytree, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in jax.tree_util order (sorted dict keys);
    ``is_leaf(node)`` True stops the walk at that node (as in JAX)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves, is_leaf)


# The walks are module-level functions, not closures over the leaf list:
# a closure that calls itself is a reference cycle, which would keep
# every leaf it saw (whole models) alive until the cyclic GC ran.
def _flatten(t, leaves: List[Any], is_leaf):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return ("leaf", None, ())
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys,
                tuple(_flatten(t[k], leaves, is_leaf) for k in keys))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return ("namedtuple", type(t),
                tuple(_flatten(x, leaves, is_leaf) for x in t))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, None,
                tuple(_flatten(x, leaves, is_leaf) for x in t))
    if t is None:
        return ("none", None, ())
    leaves.append(t)
    return ("leaf", None, ())


def tree_unflatten(treedef: Any, leaves) -> Pytree:
    return _build(treedef, iter(leaves))


def _build(d, it):
    kind, meta, children = d
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(meta, children)}
    built = [_build(c, it) for c in children]
    if kind == "namedtuple":
        return meta(*built)
    return built if kind == "list" else tuple(built)


def tree_paths(tree: Pytree) -> List[str]:
    """Each leaf's path, "/"-joined, in :func:`tree_flatten` order: dict
    keys, sequence indices, and ``.name`` for a NamedTuple field — the
    strings the JAX package's sharding rules match against."""
    out: List[str] = []

    def rec(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], path + (str(k),))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for name, x in zip(t._fields, t):
                rec(x, path + ("." + name,))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                rec(x, path + (str(i),))
        elif t is not None:
            out.append("/".join(path))

    rec(tree, ())
    return out


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


def dot(a: Pytree, b: Pytree) -> torch.Tensor:
    """Σ over leaves of ⟨a_leaf, b_leaf⟩."""
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def distance(a: Pytree, b: Pytree) -> torch.Tensor:
    return norm(sub(a, b))


def cosine_similarity(a: Pytree, b: Pytree, eps: float = 1e-12
                      ) -> torch.Tensor:
    return dot(a, b) / (norm(a) * norm(b) + eps)


def random_like(gen: torch.Generator, a: Pytree, scale_: float = 1.0
                ) -> Pytree:
    """A standard normal tree shaped like ``a``, times ``scale_``, drawn
    leaf after leaf from ``gen`` (on ``gen``'s device; f32 where a leaf
    is not floating point) — the sharpness probes' directions."""
    def draw(leaf):
        dtype = leaf.dtype if leaf.is_floating_point() else torch.float32
        return torch.randn(leaf.shape, generator=gen, dtype=dtype,
                           device=gen.device).to(leaf.device) * scale_
    return tree_map(draw, a)


def filter_normalize(direction: Pytree, reference: Pytree,
                     eps: float = 1e-10) -> Pytree:
    """Li et al. (NeurIPS'18)'s loss-landscape normalization as the JAX
    package writes it: each direction leaf scaled to the norm of its
    reference leaf."""
    def norm_leaf(d, r):
        return d * (torch.linalg.vector_norm(r) /
                    (torch.linalg.vector_norm(d) + eps))
    return tree_map(norm_leaf, direction, reference)
