"""Tensor-parallel compute over the mesh's ``model`` axis, Megatron style.

The counterpart of what XLA's SPMD partitioner does for the JAX package
when it jits a step under ``rules.param_pspecs``' ``fsdp_tp`` shardings:
the ranks of a ``model`` group split the heads, the MLP and the
vocabulary of each step instead of each computing the whole model.

A rank keeps its own ``model`` tile of the leaves the rules shard over
``model`` (``TPContext.local``): the q heads (and the kv heads, when
|model| divides them) and their biases, the MLP's columns, the rows of
the out-projections, the vocabulary of ``embed`` and ``lm_head``, and
the ``lora_b`` of the column-parallel linears.  Everything else is whole
on every rank of the group.  The dense token archs only
(:func:`plan`); the other families keep the pod's gather-then-compute.

Four autograd functions carry the collectives, each an all-reduce over
the ``model`` group counted as the pod's ``"tp"`` kind with its bytes
(``repro_torch.fl.pod.COLLECTIVES``):

  * :func:`copy_to_model` — identity forward, all-reduce backward: the
    replicated input of a column-parallel linear, and a whole leaf whose
    ``model`` ranks compute different parts of its gradient
    (:meth:`TPContext.partial`: replicated kv projections, the per-head
    norms, the ``lora_a`` of a row-parallel linear), so that every rank
    holds the whole gradient;
  * :func:`reduce_from_model` — all-reduce forward, identity backward:
    the partial output of a row-parallel linear, in its dtype (bf16 on
    the card, as Megatron reduces);
  * :func:`vocab_embedding` — the lookup of the rank's vocabulary rows,
    zero outside them, then one all-reduce;
  * :func:`vocab_cross_entropy` — ``_xent`` over vocabulary-parallel
    logits: the max, Σexp and the gold logit all-reduced in f32, the
    ignore label kept.

:class:`TPParams` is the model-local tree (``fl.pod.ShardedFlatOps``
builds it): a dict that carries its :class:`TPContext` to the model
(``fl.task.lm_task``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.utils import tree_math as tm

Pytree = Any
MODEL = "model"


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which parts of a dense block split over ``model`` ranks: the heads
    (|model| divides ``n_heads``, and divides ``n_kv_heads`` or is a
    multiple of it, so that a rank's q heads read whole kv groups or one
    kv head), the kv heads (|model| divides ``n_kv_heads``; else the kv
    projections stay whole and each rank computes the one kv head its q
    heads read), the MLP (divides ``d_ff``) and the vocabulary (divides
    ``vocab_size``)."""
    attn: bool
    kv: bool
    mlp: bool
    vocab: bool


def plan(cfg, size: int) -> Optional[TPPlan]:
    """The plan of ``cfg`` on ``size`` model ranks, or None: one rank, or
    an arch outside the dense token family (MoE, MLA, SSM, hybrid, VLM,
    audio), which keeps gather-then-compute."""
    if size <= 1 or cfg.arch_type != "dense" or cfg.attention != "gqa" \
            or cfg.input_mode != "tokens" or cfg.is_moe or cfg.mtp \
            or cfg.n_codebooks != 1:
        return None
    kv = cfg.n_kv_heads % size == 0
    attn = cfg.n_heads % size == 0 and (kv or size % cfg.n_kv_heads == 0)
    p = TPPlan(attn=attn, kv=attn and kv,
               mlp=cfg.d_ff % size == 0, vocab=cfg.vocab_size % size == 0)
    return p if (p.attn or p.mlp or p.vocab) else None


_LOCAL = {
    "attn": r"^blocks/attn/wq/(w|b|lora_b)$|^blocks/attn/wo/w$",
    "kv": r"^blocks/attn/(wk|wv)/(w|b|lora_b)$",
    "mlp": r"^blocks/mlp/(w_gate|w_up)/(w|lora_b)$|^blocks/mlp/w_down/w$",
    "vocab": r"^(embed|lm_head)$",
}
_PARTIAL = {
    # per-head norms on the local heads; the row-parallel lora_a's rows
    "attn": r"^blocks/attn/(q_norm|k_norm)/scale$|^blocks/attn/wo/lora_a$",
    # replicated kv: each rank computes the kv heads its q heads read
    "kv_whole": r"^blocks/attn/(wk|wv)/(w|b|lora_b)$",
    "mlp": r"^blocks/mlp/w_down/lora_a$",
}


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    """One rank's view of its ``model`` group: the mesh (None for a
    layout that runs nothing), the group's size, this rank's coordinate
    on it, the plan, and the head counts."""
    mesh: Any
    size: int
    rank: int
    plan: TPPlan
    n_heads: int
    n_kv_heads: int
    vocab_size: int

    @property
    def group(self):
        """The ``model`` group's process group (made on first use)."""
        return self.mesh.group(MODEL)

    def _on(self, key: str) -> bool:
        if key == "kv_whole":
            return self.plan.attn and not self.plan.kv
        return getattr(self.plan, key)

    def local(self, path: str) -> bool:
        """Whether the leaf at ``path`` stays this rank's ``model`` tile."""
        return any(self._on(k) and re.search(p, path)
                   for k, p in _LOCAL.items())

    def partial(self, path: str) -> bool:
        """Whether the leaf at ``path`` is whole on every rank while the
        ranks compute different parts of its gradient, which then sums
        over ``model`` (:func:`copy_to_model` on the leaf)."""
        return any(self._on(k) and re.search(p, path)
                   for k, p in _PARTIAL.items())

    # -- the local heads and vocabulary ---------------------------------

    @property
    def heads(self) -> int:
        """The q heads of this rank."""
        return self.n_heads // self.size

    @property
    def kv_range(self):
        """``(lo, n)``: the kv heads this rank's q heads read (one, when
        the kv projections stay whole)."""
        if self.plan.kv:
            n = self.n_kv_heads // self.size
            return self.rank * n, n
        return self.rank // (self.size // self.n_kv_heads), 1

    @property
    def vocab_range(self):
        n = self.vocab_size // self.size
        return self.rank * n, n

    def sum_partial_grads(self, tree: Pytree, prefix: str = "") -> Pytree:
        """``tree`` with every :meth:`partial` leaf passed through
        :func:`copy_to_model`: each such gradient sums over the group
        once a step."""
        paths = tm.tree_paths(tree)
        leaves, treedef = tm.tree_flatten(tree)
        return tm.tree_unflatten(treedef, [
            copy_to_model(x, self) if self.partial(prefix + p) else x
            for p, x in zip(paths, leaves)])


def context(cfg, mesh) -> Optional[TPContext]:
    """The tensor-parallel context of ``cfg`` on ``mesh`` (a
    ``launch.mesh.Mesh``), or None when :func:`plan` gives none."""
    size = mesh.axis_size(MODEL)
    p = plan(cfg, size)
    if p is None:
        return None
    return TPContext(mesh=mesh, size=size,
                     rank=mesh.coords.get(MODEL, 0), plan=p,
                     n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     vocab_size=cfg.vocab_size)


class TPParams(dict):
    """A model-local parameter tree (a dict) and its :class:`TPContext`."""

    def __init__(self, tree: dict, tp: TPContext):
        super().__init__(tree)
        self.tp = tp


def context_of(params) -> Optional[TPContext]:
    """The context a :class:`TPParams` carries (None for a plain tree)."""
    return getattr(params, "tp", None)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, tp: TPContext,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``) over the group in place, counted "tp"."""
    from repro_torch.fl.pod import _count
    dist.all_reduce(t, op=op, group=tp.group)
    _count("tp", t.numel() * t.element_size())
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Identity forward; the gradient summed over the group."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group; identity backward."""
    return _ReduceFromModel.apply(x, tp)


class _VocabEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, tp):
        lo, n = tp.vocab_range
        ids = tokens.long() - lo
        inside = (ids >= 0) & (ids < n)
        ids = torch.where(inside, ids, torch.zeros_like(ids))
        ctx.save_for_backward(ids, inside)
        ctx.rows = table.shape[0]
        out = table[ids] * inside[..., None].to(table.dtype)
        return _all_reduce(out, tp)

    @staticmethod
    def backward(ctx, g):
        ids, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], g, torch.zeros_like(g))
        gt = g.new_zeros((ctx.rows, g.shape[-1]))
        gt.index_add_(0, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
        return gt, None, None


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor,
                    tp: TPContext) -> torch.Tensor:
    """``embed[tokens]`` from this rank's rows ``table`` of the
    vocabulary: a token outside them gives zero, then one all-reduce."""
    return _VocabEmbedding.apply(table, tokens, tp)


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp, ignore):
        logits = logits.float()
        lo, n = tp.vocab_range
        m = _all_reduce(torch.amax(logits, dim=-1), tp, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = _all_reduce(torch.sum(e, dim=-1), tp)
        ids = labels.long() - lo
        inside = (ids >= 0) & (ids < n) & (labels != ignore)
        ids = torch.where(inside, ids, torch.zeros_like(ids))
        gold = torch.gather(logits, -1, ids[..., None])[..., 0]
        gold = _all_reduce(torch.where(inside, gold,
                                       torch.zeros_like(gold)), tp)
        ctx.save_for_backward(e, s, ids, inside)
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, s, ids, inside = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, ids[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        tp: TPContext, ignore: int = -1):
    """``models.transformer._xent`` over this rank's vocabulary columns
    ``logits`` ``(..., V/|model|)``: ``(mean nll over the kept labels,
    mask)``, the log-sum-exp in f32 across the group."""
    nll = _VocabCrossEntropy.apply(logits, labels, tp, ignore)
    mask = (labels != ignore).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0), \
        mask


def gather_vocab(logits: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's columns: one
    all-gather over the group, counted "tp" (the serve steps' output)."""
    from repro_torch.fl.pod import _count
    from repro_torch.launch.mesh import all_gather_into
    full = torch.empty((tp.size,) + tuple(logits.shape), dtype=logits.dtype,
                       device=logits.device)
    all_gather_into(full.reshape(-1), logits.contiguous().reshape(-1),
                    tp.group)
    _count("tp", full.numel() * full.element_size())
    return full.movedim(0, -2).reshape(logits.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# the linears
# ---------------------------------------------------------------------------

def column_linear(p: Pytree, x: torch.Tensor, xc: torch.Tensor,
                  tp: TPContext, cols: Optional[slice] = None,
                  dtype=None) -> torch.Tensor:
    """A column-parallel linear on this rank's output columns:
    ``xc·w + (α/r)·copy(x·A)·B + b`` in ``models.layers.linear``'s order,
    with ``xc`` the input after :func:`copy_to_model` (its gradient sums
    the ranks' columns) and ``x`` the same input before it: ``x·A`` is
    computed alike on every rank and passes :func:`copy_to_model`, so
    ``dA`` and the adapter's ``dx`` sum the output columns once.  ``cols``
    takes those columns of whole ``w``, ``b`` and ``B`` (the replicated
    kv projections)."""
    from repro_torch.models.layers import lora_scale

    def take(t):
        return t if cols is None else t[..., cols]
    dtype = dtype or x.dtype
    y = torch.matmul(xc, take(p["w"]).to(dtype))
    if "lora_a" in p:
        a, b = p["lora_a"].to(dtype), take(p["lora_b"]).to(dtype)
        z = copy_to_model(torch.matmul(x, a), tp)
        y = y + lora_scale(a.shape[-1]) * torch.matmul(z, b)
    if "b" in p:
        y = y + take(p["b"]).to(dtype)
    return y


def row_linear(p: Pytree, x: torch.Tensor, tp: TPContext,
               dtype=None) -> torch.Tensor:
    """A row-parallel linear from this rank's input columns ``x``:
    ``reduce(x·w) + (α/r)·reduce(x·A[rows])·B + b`` — the rank's rows of
    the whole ``A``, the whole ``B`` and the bias added once, after the
    reduce."""
    from repro_torch.models.layers import lora_scale
    dtype = dtype or x.dtype
    y = reduce_from_model(torch.matmul(x, p["w"].to(dtype)), tp)
    if "lora_a" in p:
        n = x.shape[-1]
        a = p["lora_a"][tp.rank * n:(tp.rank + 1) * n].to(dtype)
        z = reduce_from_model(torch.matmul(x, a), tp)
        y = y + lora_scale(a.shape[-1]) * torch.matmul(z, p["lora_b"].to(
            dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y
