"""Task abstraction: binds a model to loss / representation / prediction
functions so the FL machinery is model-agnostic.

The counterpart of ``repro/fl/task.py``: ``Task``, ``vision_task``,
``charlm_task`` and ``lm_task``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import paper_models as pm
from repro_torch.models import transformer as tf
from repro_torch.sharding.batch_group import batch_group_of
from repro_torch.sharding.tensor_parallel import context_of

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Task:
    """A learnable task: everything FL algorithms need about the model.

    init(gen)                    -> params on ``gen``'s device
    loss_fn(params, bx, by, rng) -> scalar loss            (local SGD)
    repr_fn(params, bx)          -> (B, d) representation
    predict_fn(params, bx)       -> predicted int labels   (test accuracy)
    shapes()                     -> the params on the ``meta`` device
                                    (None: ``init`` on the CPU gives them)
    model_cfg                    -> the decoder LM's config (token
                                    tasks), which the pod reads for its
                                    tensor-parallel plan; else None
    """

    name: str
    kind: str                      # vision | charlm | tokenlm
    init: Callable[[torch.Generator], Pytree]
    loss_fn: Callable[..., torch.Tensor]
    repr_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]
    predict_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]
    shapes: Optional[Callable[[], Pytree]] = None
    model_cfg: Any = None

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
    """Paper vision models (LeNet-5, CNN-FEMNIST, CNN-Fashion) and the
    MLP.  The loss hands ``rng`` (the step's dropout source) to the
    model; representation and prediction run without dropout."""
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


def charlm_task(vocab: int = 64, d_embed: int = 8, d_hidden: int = 256) -> Task:
    """CharLSTM-256 next-char prediction (Shakespeare stand-in):
    ``bx`` (B, S) int tokens, ``by`` (B, S) next chars."""

    def init(gen):
        return pm.charlstm_init(gen, vocab=vocab, d_embed=d_embed,
                                d_hidden=d_hidden)

    def loss_fn(params, bx, by, rng=None):
        return _softmax_xent(pm.charlstm_apply(params, bx), by)

    def repr_fn(params, bx):
        return pm.charlstm_apply(params, bx)[:, -1]  # last-position logits

    def predict_fn(params, bx):
        return torch.argmax(pm.charlstm_apply(params, bx), dim=-1)

    return Task(name="charlstm", kind="charlm", init=init, loss_fn=loss_fn,
                repr_fn=repr_fn, predict_fn=predict_fn)


def lm_task(cfg: "tf.TransformerConfig") -> Task:
    """Federated next-token training over a decoder LM of the zoo:
    ``bx`` tokens (B, S) int, ``by`` labels (B, S) int (−1 ignored).
    ``shapes`` builds the tree on the ``meta`` device, so packing plans
    and byte counts of a full-size model allocate nothing.  The loss and
    the representation run tensor-parallel on a model-local tree
    (``sharding.tensor_parallel.TPParams``, the pod's); the MoE layers of
    all three functions dispatch over the batch group such a tree
    carries (``sharding.batch_group``)."""

    def init(gen):
        return tf.init_lm(cfg, gen=gen)

    def loss_fn(params, bx, by, rng=None):
        loss, _ = tf.lm_loss(params, cfg, {"tokens": bx, "labels": by},
                             tp=context_of(params),
                             group=batch_group_of(params))
        return loss

    def repr_fn(params, bx):
        _, _, hidden = tf.lm_forward(params, cfg, {"tokens": bx},
                                     tp=context_of(params),
                                     group=batch_group_of(params))
        return torch.mean(hidden.float(), dim=1)

    def predict_fn(params, bx):
        logits, _, _ = tf.lm_forward(params, cfg, {"tokens": bx},
                                     group=batch_group_of(params))
        return torch.argmax(logits, dim=-1)

    def shapes():
        return tf.init_lm(cfg, device="meta")

    return Task(name=cfg.name, kind="tokenlm", init=init, loss_fn=loss_fn,
                repr_fn=repr_fn, predict_fn=predict_fn, shapes=shapes,
                model_cfg=cfg)
