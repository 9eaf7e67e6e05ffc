"""Loss-landscape and data-consistency diagnostics (RQ4 / Fig. 7).

The counterpart of ``repro/core/diagnostics.py``.  The paper plots loss
landscapes along Li et al. (NeurIPS'18)'s filter-normalized directions
and argues that cyclic pre-training lands in flatter basins; these
functions quantify that instead of plotting:

  sharpness_probe   — E_d[L(w + α·d) − L(w)] over random
                      filter-normalized directions d (smaller = flatter);
  hessian_top_eig   — the top Hessian eigenvalue by power iteration on
                      Hessian-vector products;
  landscape_slice   — L(w + α·d) for α ∈ [−radius, radius] (the numeric
                      form of Fig. 7's surface);
  client_similarity — Corollary 1's knob: mean pairwise cosine of the
                      clients' label distributions and their mean total
                      variation from the global one.

Random directions and the power iteration's start vector are drawn from
an explicit ``torch.Generator``, or injected (``directions``,
``direction``, ``v0``) — the parity tests hand in the JAX package's
threefry draws that way, and ``chip_smoke.py`` the same draws to the
card and to the CPU.

The HVP is a double backward: the gradient is built once with
``create_graph=True`` and each iteration differentiates ⟨∇L, v⟩ again
(``torch.autograd.grad`` with ``grad_outputs=v``).  The JAX package
takes forward-over-reverse (``jax.jvp`` of ``jax.grad``); reverse over
reverse gives the same product and runs through the double-backward
formulas of cuDNN's convolution and of max pooling, which are defined
for every op the paper models run, where forward-mode derivatives of
the backward ops are not.  The functions run on whatever device the
params and the bound batch live on (``make_batch_loss``: CUDA by
default, TF32 off through ``resolve_device``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device, seeded_generator

Pytree = Any
LossFn = Callable[[Pytree], torch.Tensor]


def _generator(gen: Optional[torch.Generator], params: Pytree
               ) -> torch.Generator:
    if gen is not None:
        return gen
    return seeded_generator(0, tm.tree_leaves(params)[0].device)


def _on(tree: Pytree, like: Pytree) -> Pytree:
    """``tree``'s leaves as tensors on ``like``'s devices and dtypes (an
    injected direction may arrive as numpy)."""
    def one(d, p):
        if not isinstance(d, torch.Tensor):
            d = torch.from_numpy(np.array(d))
        return d.to(device=p.device, dtype=p.dtype)
    return tm.tree_map(one, tree, like)


@torch.no_grad()
def sharpness_probe(loss_fn: LossFn, params: Pytree,
                    gen: Optional[torch.Generator] = None, n_dirs: int = 8,
                    alphas: Tuple[float, ...] = (0.1, 0.5, 1.0),
                    directions: Optional[Sequence[Pytree]] = None
                    ) -> Dict[str, float]:
    """Mean loss increase along random filter-normalized directions.

    ``loss_fn``: params -> scalar (bind the eval batch first).  Returns
    ``{'base_loss', 'sharpness@<alpha>', ...}``, each entry E_d[L(w + α
    d) − L(w)] with d's leaves scaled to the norms of w's.
    ``directions`` (``n_dirs`` trees shaped like ``params``) replaces
    the draws from ``gen``."""
    base = float(loss_fn(params))
    out = {"base_loss": base}
    if directions is None:
        g = _generator(gen, params)
        directions = [tm.random_like(g, params) for _ in range(n_dirs)]
    deltas = {a: [] for a in alphas}
    for d in directions:
        d = tm.filter_normalize(_on(d, params), params)
        for a in alphas:
            deltas[a].append(float(loss_fn(tm.add_scaled(params, d, a)))
                             - base)
    for a in alphas:
        out[f"sharpness@{a}"] = float(np.mean(deltas[a]))
    return out


def hessian_top_eig(loss_fn: LossFn, params: Pytree,
                    gen: Optional[torch.Generator] = None, n_iter: int = 12,
                    v0: Optional[Pytree] = None) -> float:
    """Top Hessian eigenvalue by power iteration on the HVP (a double
    backward; see the module doc).  ``v0`` replaces the start vector
    drawn from ``gen``."""
    leaves, treedef = tm.tree_flatten(params)
    w = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(tm.tree_unflatten(treedef, w)),
                                    w, create_graph=True)

    def hvp(v):
        return list(torch.autograd.grad(grads, w, grad_outputs=v,
                                        retain_graph=True))

    v = (tm.random_like(_generator(gen, params), params) if v0 is None
         else _on(v0, params))
    v = tm.tree_leaves(v)
    v = tm.scale(v, 1.0 / (tm.norm(v) + 1e-12))
    eig = 0.0
    for _ in range(n_iter):
        hv = hvp(v)
        eig = float(tm.dot(v, hv))
        v = tm.scale(hv, 1.0 / (tm.norm(hv) + 1e-12))
    return eig


@torch.no_grad()
def landscape_slice(loss_fn: LossFn, params: Pytree,
                    gen: Optional[torch.Generator] = None,
                    n_points: int = 11, radius: float = 1.0,
                    direction: Optional[Pytree] = None
                    ) -> Dict[str, np.ndarray]:
    """1-D filter-normalized loss slice: L(w + α d) for α ∈ [−radius,
    radius].  ``direction`` replaces the draw from ``gen``."""
    d = (tm.random_like(_generator(gen, params), params)
         if direction is None else _on(direction, params))
    d = tm.filter_normalize(d, params)
    alphas = np.linspace(-radius, radius, n_points)
    losses = np.array([float(loss_fn(tm.add_scaled(params, d, float(a))))
                       for a in alphas])
    return {"alpha": alphas, "loss": losses}


def client_similarity(labels_per_client: np.ndarray, n_classes: int
                      ) -> Dict[str, float]:
    """Label-distribution overlap (Corollary 1's knob) over
    ``labels_per_client``, an ``(n_clients, n_samples)`` int array."""
    dists = []
    for ly in labels_per_client:
        h = np.bincount(np.asarray(ly).ravel() % n_classes,
                        minlength=n_classes)
        dists.append(h / max(h.sum(), 1))
    D = np.stack(dists)                            # (C, n_classes)
    g = D.mean(axis=0)
    norms = np.linalg.norm(D, axis=1, keepdims=True) + 1e-12
    cos = (D @ D.T) / (norms * norms.T)
    iu = np.triu_indices(len(D), k=1)
    tv = 0.5 * np.abs(D - g).sum(axis=1)
    return {
        "mean_pairwise_cos": float(cos[iu].mean()) if len(iu[0]) else 1.0,
        "mean_tv_from_global": float(tv.mean()),
        "min_pairwise_cos": float(cos[iu].min()) if len(iu[0]) else 1.0,
    }


def make_batch_loss(task, x, y, device: Device = None) -> LossFn:
    """A fixed eval batch bound into ``params -> loss`` on ``device``
    (default CUDA; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    bx = torch.as_tensor(np.asarray(x)).to(dev)
    by = torch.as_tensor(np.asarray(y)).to(device=dev, dtype=torch.int64)

    def loss(params):
        return task.loss_fn(params, bx, by, None)

    return loss
