"""Production step functions: train / prefill / serve(decode) (the
counterpart of ``repro/launch/steps.py``).

  train_step   : one SGD(+momentum) step on a global batch, with
                 microbatch gradient accumulation streamed directly into
                 the momentum buffer (no separate f32 accumulator: the
                 update  m ← β·m + Σᵢ gᵢ/n  starts the carry at β·m).
  prefill_step : full-sequence forward building the decode cache.
  serve_step   : ONE new token against a seq_len-sized KV/SSM cache.

Gradients come from ``torch.autograd.grad`` over the param tree's
floating leaves; every input mode of the zoo trains here (``tokens``,
vlm ``patch_embeds`` + ``tokens``, audio ``frame_embeds``), with the
MoE aux and the multi-token losses that ``lm_loss`` adds.  Steps are
functional, as in the JAX package: new params and momentum come back,
the inputs are not modified.  ``momentum_specs`` describes the momentum
tree on the ``meta`` device, allocating nothing.

SGD+momentum is the paper's optimizer family (CyclicFL trains with SGD).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models.transformer import (
    TransformerConfig, decode_step, lm_loss, prefill)
from repro_torch.sharding.tensor_parallel import TPParams, context_of
from repro_torch.utils import tree_math as tm

Pytree = Any

__all__ = ["TrainSpec", "make_train_step", "make_prefill_step",
           "make_serve_step", "init_momentum", "momentum_specs"]


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    n_micro: int = 1              # microbatch accumulation factor


def _split_micro(batch: Dict[str, torch.Tensor], n_micro: int
                 ) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n_micro, B/n_micro, ...) taking strided rows, so
    microbatch i holds rows i, i + n_micro, i + 2·n_micro, ..."""

    def split(x):
        B = x.shape[0]
        assert B % n_micro == 0, (B, n_micro)
        return x.reshape((B // n_micro, n_micro) + tuple(x.shape[1:])
                         ).swapaxes(0, 1)

    return {k: split(v) for k, v in batch.items()}


def _value_and_grad(cfg: TransformerConfig, params: Pytree, batch):
    """``lm_loss`` and its gradient w.r.t. every floating leaf, in
    ``tree_leaves`` order: zeros for a leaf the loss does not reach and
    for the non-floating leaves, as ``jax.grad`` gives.  A model-local
    tree (``tensor_parallel.TPParams``) runs tensor-parallel: the
    gradient of each leaf is that of the rank's tile, or of the whole
    leaf (summed over ``model`` where the ranks computed parts of it)."""
    tp = context_of(params)
    leaves, treedef = tm.tree_flatten(params)
    live = [p.detach().requires_grad_(True) if p.is_floating_point() else p
            for p in leaves]
    with torch.enable_grad():
        loss, _ = lm_loss(tm.tree_unflatten(treedef, live), cfg, batch,
                          tp=tp)
        wrt = [p for p in live if p.is_floating_point()]
        grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    out = []
    for p in leaves:
        g = next(grads) if p.is_floating_point() else None
        out.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), out


def make_train_step(cfg: TransformerConfig, spec: TrainSpec,
                    value_and_grad: Callable = _value_and_grad) -> Callable:
    """(params, mom, batch) -> (params, mom, metrics).  ``value_and_grad
    (cfg, params, batch) -> (loss, grads in tree_leaves order)`` gives
    the gradient: by default of ``lm_loss`` over the param tree (a
    model-local tree steps tensor-parallel and comes back as one, with
    its context); the compile analysis passes one over a rank's rows of
    the flat buckets (``repro_torch.launch.dryrun``)."""

    def train_step(params, mom, batch):
        tp = context_of(params)
        p_leaves, treedef = tm.tree_flatten(params)
        m_leaves = tm.tree_leaves(mom)
        if spec.n_micro == 1:
            loss, grads = value_and_grad(cfg, params, batch)
            new_m = [spec.momentum * m + g.to(m.dtype)
                     for m, g in zip(m_leaves, grads)]
        else:
            micro = _split_micro(batch, spec.n_micro)
            new_m = [spec.momentum * m for m in m_leaves]
            losses = []
            for i in range(spec.n_micro):
                mb = {k: v[i] for k, v in micro.items()}
                loss_i, grads = value_and_grad(cfg, params, mb)
                new_m = [c + g.to(c.dtype) / spec.n_micro
                         for c, g in zip(new_m, grads)]
                losses.append(loss_i)
            loss = torch.stack(losses).mean()
        if spec.weight_decay:
            new_m = [m + spec.weight_decay * p.to(m.dtype)
                     for m, p in zip(new_m, p_leaves)]
        new_p = [(p - spec.lr * m).to(p.dtype)
                 for p, m in zip(p_leaves, new_m)]
        new_params = tm.tree_unflatten(treedef, new_p)
        if tp is not None:
            new_params = TPParams(new_params, tp)
        return (new_params, tm.tree_unflatten(treedef, new_m),
                {"loss": loss})

    return train_step


def make_prefill_step(cfg: TransformerConfig, max_len: int) -> Callable:
    """(params, batch) -> (last-token logits, decode cache); a model-local
    tree (``tensor_parallel.TPParams``) runs tensor-parallel."""

    def prefill_step(params, batch):
        logits, cache, _ = prefill(params, cfg, batch, max_len,
                                   tp=context_of(params))
        return logits, cache

    return prefill_step


def make_serve_step(cfg: TransformerConfig) -> Callable:
    """(params, token, cache, cache_len) -> (logits, cache): ONE token;
    the cache is updated in place and ``cache_len`` is a host int."""

    def serve_step(params, token, cache, cache_len):
        return decode_step(params, cfg, token, cache, cache_len,
                           tp=context_of(params))

    return serve_step


def init_momentum(params: Pytree, dtype: torch.dtype = torch.float32
                  ) -> Pytree:
    """Zeros of ``dtype`` for every floating leaf, ``zeros_like`` for the
    others, on each leaf's device."""
    return tm.tree_map(
        lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
        if p.is_floating_point() else torch.zeros_like(p), params)


def momentum_specs(params_spec: Pytree, dtype: torch.dtype = torch.float32
                   ) -> Pytree:
    """The momentum tree's shapes and dtypes as ``meta`` tensors (the
    analog of ``jax.ShapeDtypeStruct``): nothing is allocated."""
    return tm.tree_map(
        lambda p: torch.empty(tuple(p.shape), device="meta",
                              dtype=dtype if p.dtype.is_floating_point
                              else p.dtype), params_spec)
