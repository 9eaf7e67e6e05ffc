"""Task abstraction: binds a model to loss / representation / prediction
functions so the FL machinery is model-agnostic.

The counterpart of ``repro/fl/task.py`` (``Task`` and ``vision_task``;
``charlm_task`` and ``lm_task`` wait for ROADMAP.md items M2d and M12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import paper_models as pm

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Task:
    """A learnable task: everything FL algorithms need about the model.

    init(gen)                    -> params on ``gen``'s device
    loss_fn(params, bx, by, rng) -> scalar loss            (local SGD)
    repr_fn(params, bx)          -> (B, d) representation
    predict_fn(params, bx)       -> predicted int labels   (test accuracy)
    """

    name: str
    kind: str                      # vision
    init: Callable[[torch.Generator], Pytree]
    loss_fn: Callable[..., torch.Tensor]
    repr_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]
    predict_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]

    def accuracy(self, params: Pytree, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        pred = self.predict_fn(params, x)
        return torch.mean((pred == y).to(torch.float32))


def _softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(logsumexp(logits) − logits[label]), as the JAX package
    writes it."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def vision_task(model: str = "lenet5", n_classes: int = 10, in_ch: int = 3,
                seed_kwargs: Optional[dict] = None) -> Task:
    """Paper vision models (LeNet-5, CNN-FEMNIST) and the MLP."""
    init_fn, apply_fn, kind = pm.PAPER_MODELS.get(model)
    kw = seed_kwargs or {}

    def init(gen):
        return init_fn(gen, n_classes=n_classes, in_ch=in_ch, **kw)

    def loss_fn(params, bx, by, rng=None):
        logits = apply_fn(params, bx, train=True, rng=rng)
        return _softmax_xent(logits, by)

    def repr_fn(params, bx):
        return apply_fn(params, bx, train=False)

    def predict_fn(params, bx):
        return torch.argmax(apply_fn(params, bx, train=False), dim=-1)

    return Task(name=model, kind=kind, init=init, loss_fn=loss_fn,
                repr_fn=repr_fn, predict_fn=predict_fn)
