"""Minimal optax-style optimizers over trees of tensors.

The counterpart of ``repro/optim/optimizers.py`` (``OptState``,
``AdamWState``, ``sgd``, ``adamw``) as the tree path's server optimizer
uses them.  An Optimizer is an (init, update) pair; the state is itself
a tree, and the step count stays a device tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import tree_math as tm

Pytree = Any


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


class AdamWState(NamedTuple):
    mu: Pytree
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], OptState]
    update: Callable[[Pytree, OptState, Pytree], tuple]

    def apply(self, grads: Pytree, state: OptState, params: Pytree):
        updates, new_state = self.update(grads, state, params)
        return apply_updates(params, updates), new_state


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tm.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zero_step(params: Pytree) -> torch.Tensor:
    leaves = tm.tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD + heavy-ball momentum + decoupled weight decay."""
    use_momentum = momentum != 0.0

    def init(params):
        inner = tm.zeros_like(params) if use_momentum else ()
        return OptState(step=_zero_step(params), inner=inner)

    def update(grads, state, params):
        if weight_decay:
            grads = tm.tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                                grads, params)
        if use_momentum:
            inner = tm.tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                                state.inner, grads)
            eff = inner
        else:
            eff, inner = grads, ()
        updates = tm.tree_map(lambda g: -lr * g, eff)
        return updates, OptState(step=state.step + 1, inner=inner)

    return Optimizer(init=init, update=update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=_zero_step(params),
                        inner=AdamWState(mu=tm.zeros_like(params),
                                         nu=tm.zeros_like(params)))

    def update(grads, state, params):
        step = state.step + 1
        mu = tm.tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                         state.inner.mu, grads)
        nu = tm.tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
            state.inner.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(u.dtype)
            return -lr * u

        updates = tm.tree_map(upd, mu, nu, params)
        return updates, OptState(step=step, inner=AdamWState(mu=mu, nu=nu))

    return Optimizer(init=init, update=update)
