"""An MoE layer's dispatch over the pod's batch group.

On the JAX pod the client batch is one global array whose rows XLA
shards over (pod, data), so each MoE layer takes its capacity, its slots
and its load-balance loss over the whole batch.  The port's pod gives
each rank its rows of the batch (``fl.pod``'s ``batch_shard``); where
they split over more than one rank, the step's params carry the
:class:`BatchGroup` (``tensor_parallel.TPParams.batch``, set by
:func:`on_batch_group`) and ``models.layers.moe`` dispatches over it.

Its collectives are counted as the pod's ``"moe"`` kind with their bytes
(``repro_torch.fl.pod.COLLECTIVES``): the per-expert counts' all-gather
(:func:`gather_counts`), the aux loss's sums (:func:`batch_sum`), the
dispatch buffer's reduce-scatter along its slots
(:func:`scatter_slots`) and the experts' output's all-gather
(:func:`gather_slots`), each the other's backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.tensor_parallel import TPParams, context_of


@dataclasses.dataclass(frozen=True, eq=False)
class BatchGroup:
    """The ranks over which the pod splits a step's batch, (pod, data):
    the mesh, the axes, their size and this rank's row-major index over
    them (its rows of the batch, as ``fl.pod``'s ``batch_shard`` lays
    them out)."""
    mesh: Any
    axes: Tuple[str, ...]
    size: int
    index: int

    @property
    def group(self):
        return self.mesh.group(self.axes)


def batch_group(mesh) -> Optional[BatchGroup]:
    """The batch group of ``mesh``, or None when it has one rank."""
    from repro_torch.sharding.rules import batch_axes
    axes = tuple(batch_axes(mesh))
    size = math.prod(mesh.axis_size(a) for a in axes)
    if size <= 1:
        return None
    return BatchGroup(mesh=mesh, axes=axes, size=size, index=mesh.index(axes))


def on_batch_group(params, bg: BatchGroup) -> TPParams:
    """``params`` (a plain tree or a ``TPParams``, whose context it keeps)
    carrying the batch group ``bg``."""
    return TPParams(params, context_of(params), bg)


def batch_group_of(params) -> Optional[BatchGroup]:
    """The batch group a ``TPParams`` carries (None for a plain tree)."""
    return getattr(params, "batch", None)


# ---------------------------------------------------------------------------
# the collectives, counted "moe"
# ---------------------------------------------------------------------------

def _count(t: torch.Tensor) -> None:
    from repro_torch.fl.pod import _count
    _count("moe", t.numel() * t.element_size())


def _all_reduce(t: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=bg.group)
    _count(t)
    return t


def _all_gather_rows(t: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """Every rank's ``t`` of the group stacked along dim 0, in group
    order."""
    from repro_torch.launch.mesh import all_gather_into
    out = torch.empty((bg.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    all_gather_into(out, t.contiguous(), bg.group)
    _count(out)
    return out


def _reduce_scatter_rows(t: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """This rank's block of dim 0 of the group's sum of ``t``."""
    from repro_torch.launch.mesh import reduce_scatter_into
    out = torch.empty((t.shape[0] // bg.size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    reduce_scatter_into(out, t.contiguous(), bg.group)
    _count(out)
    return out


def _blocks(t: torch.Tensor, n: int) -> torch.Tensor:
    """``(E, C, d)`` as ``(n, E, C/n, d)``: the n blocks of its slots."""
    E, C, d = t.shape
    return t.view(E, n, C // n, d).movedim(1, 0)


def _unblocks(t: torch.Tensor) -> torch.Tensor:
    """:func:`_blocks`' inverse: ``(n, E, c, d)`` as ``(E, n·c, d)``."""
    n, E, c, d = t.shape
    return t.movedim(0, 1).reshape(E, n * c, d)


def _scatter(t: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    return _reduce_scatter_rows(_blocks(t, bg.size), bg)[0]


def _gather(t: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    return _unblocks(_all_gather_rows(t[None], bg))


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bg):
        ctx.bg = bg
        return _all_reduce(x.contiguous().clone(), bg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.bg), None


class _ScatterSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bg):
        ctx.bg = bg
        return _scatter(x, bg)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.bg), None


class _GatherSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bg):
        ctx.bg = bg
        return _gather(x, bg)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.bg), None


def batch_sum(x: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """The sum of every rank's ``x`` over the batch group; the gradient
    summed over it too (each rank's loss holds the sum)."""
    return _BatchSum.apply(x, bg)


def gather_counts(counts: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """``(|group|, E)``: every rank's per-expert pair counts."""
    return _all_gather_rows(counts[None], bg)


def scatter_slots(buf: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """This rank's ``1/|group|`` of the slots (dim 1) of the group's
    summed ``(E, C, d)`` dispatch buffer; the gradient all-gathered
    back."""
    return _ScatterSlots.apply(buf, bg)


def gather_slots(y: torch.Tensor, bg: BatchGroup) -> torch.Tensor:
    """Every rank's slots (dim 1) of the experts' ``(E, C/|group|, d)``
    output, whole; the gradient reduce-scattered back to the slots'
    rank."""
    return _GatherSlots.apply(y, bg)
