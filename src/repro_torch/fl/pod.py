"""Pod-scale backend for the federated round engine, on torch.distributed.

The counterpart of ``repro/fl/pod.py``.  The pod is a BACKEND of the
same ``RoundStrategy`` stack as the host engine (``repro_torch.fl.
engine``): ``PodRelayStrategy`` / ``PodAggregateStrategy`` reuse its
round loop, local training and key derivation, and add the mesh's
decisions.  One process drives one device; the mesh
(``repro_torch.launch.mesh.Mesh``) is a ``DeviceMesh`` with the JAX
axis names, and this module reads it through the port's sharding rules
(``repro_torch.sharding.rules``):

  * The batch is data-parallel.  Every rank draws the same client ids
    and batch indices from the same seeded streams, computes its
    contiguous part of each step's batch over (pod, data) as
    ``rules.fl_batch_pspec`` places it (the whole batch when B does not
    divide, as the rules' fallback replicates), and averages the
    gradient buckets over that group — one ``all_reduce`` per bucket —
    before the step tail (``PodBackendMixin.grad_reducer``).  The math is
    the global batch mean up to reduction order.  Losses and eval sums
    reduce over the same group once per chunk.
  * Params ride the rounds as the rank's rows of the
    ``ShardedFlatView`` buckets (``ShardedFlatOps``), trainable and
    frozen: a rank holds only its row of each bucket, every kernel (K1,
    K6, K3, the compressed upload, K5) runs on that row with no
    collective, and top-k keeps k of each shard's population.  The
    paper's vision models replicate under every layout, so their row is
    the whole bucket.  A bucket sharded over mesh axes (the LLM trees
    under ``fsdp_tp`` and ``fsdp_only``) is all-gathered over its axes
    into whole leaves wherever the model runs: each step's loss (the
    trainable buckets through an autograd function whose backward
    reduce-scatters the gradient to the row, summed once over (pod,
    data) and never over ``model``), the eval, the anchors of fedprox
    and moon and the result.  The one collective of the update path is
    the global clip norm: each bucket's Σg² summed over its own axes.
    A gathered copy lives one step, as in FSDP.  Under ``fsdp_tp`` on a
    ``model`` axis larger than 1 the step computes tensor-parallel
    (``sharding.tensor_parallel``; ``ShardedFlatOps.tp``), under every
    algorithm and for every family whose plan splits a part: its leaves
    are gathered over each bucket's other axes only where they keep
    their ``model`` tile, and the ranks of a ``model`` group split the
    heads, the MLP, the experts, the SSM heads and the vocabulary
    (FedProx's anchor is the same model-local tree, its proximal term
    summed over ``model``); MOON's anchors, the eval and the result
    compute on whole leaves.  The tree path (``update_impl="tree"``) keeps whole
    leaves on every rank.  Under every layout, where an MoE arch's batch
    is split, each MoE layer dispatches over the batch group
    (``sharding.batch_group``, :meth:`PodBackendMixin.task_over_batch`):
    in the steps of both update paths and in the eval, its capacity,
    its slots and its aux loss are the whole batch's, as on the JAX
    pod, whose batch is one global array.
  * Per-client state (scaffold's control variates, moon's previous
    local models, the error-feedback rows of compressed uploads) lives
    in a ``ShardedClientStateStore`` whose client axis shards over
    ``data``: each rank holds its block of rows, a gather is one
    ``all_reduce`` of a zero-filled ``(K, N)`` buffer into which each
    owner writes its rows (exact), a scatter writes the owned rows.
    Where a bucket's rows differ over ``data`` the client axis stays
    whole instead: each rank holds every client's rows of its own shard.
    ``PodFLConfig(store="sparse")`` swaps in a
    ``ShardedSparseClientStateStore``: the host engine's bounded table
    of active clients with its ``capacity`` axis sharded over ``data``
    the same way, its index and LRU state replicated, and evicted rows
    spilled to every rank's host memory (one ``all_reduce`` per leaf,
    counted as ``store_spill``).

P2 aggregation differs from the host backend in schedule only.  The
sequential topology runs the K clients one after another, each adding
``coeff·(w_end − p)`` to a round-owned f32 accumulator with the
``delta_accum`` kernel (K6), then applies it with ``server_update``
("none") — peak memory ~2×params whatever K.  ``aggregation=
"hierarchical"`` groups the clients into ``n_pods`` lanes (client ``j``
runs as step ``j // G`` of lane ``j % G``).  When the lane count equals
the mesh's ``data`` size and the path is flat, the rank at data
coordinate g owns lane g's p-free partial: the accum-only K6 adds
``coeff·w_end`` of its lane's clients with no collective, and the
cross-pod combine is exactly ONE ``all_reduce`` per bucket over
``data`` (``ShardedFlatOps.lane_combine``, counted in
``COLLECTIVES``); ``−(Σcoeff)·p`` applies once after it.  Otherwise —
also whenever a bucket is sharded over ``data``, whose ranks hold
different rows — each rank keeps all G lane accumulators and sums them.  Either way the
result equals the sequential sum up to the order of addition.

The algorithms are the host engine's (fedavg, fedprox, scaffold, moon):
each client's extras and the round's client-state update come from
``AggregateStrategy.client_state``, over the stack of the clients' end
states.

``PodFLConfig.overlap`` (default True, as in the JAX package) runs the
engine's overlapped round pipeline; it is bitwise the synchronous loop.

Every task kind runs here: vision, charlm and tokenlm.  A token batch
``(B, S)`` and its labels split over (pod, data) like images, and the
eval stream's per-sample metric (a sequence's mean over its positions)
splits the same way, so its weighted mean stays exact.  A trainable
filter (``PodFLSpec.peft`` / ``trainable_filter``) splits the buckets as
on the host engine: the frozen buckets are this rank's rows of the
``ShardedFlatView``'s ``frozen:`` groups, placed once per phase where
``rules.frozen_flat_shardings`` puts them and merged at the loss.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.cyclic import HOST_RNG_OFFSET_P1
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import compression, privacy
from repro_torch.fl.engine import (
    DENSE_STORE,
    AggregateStrategy,
    DenseClientStateStore,
    RelayStrategy,
    RoundSchedule,
    SparseClientStateStore,
    run_rounds,
)
from repro_torch.fl.local import (FlatParamOps, LocalSpec,
                                  effective_trainable_filter, make_local_fn,
                                  param_shapes, validate_peft,
                                  validate_update_impl)
from repro_torch.fl.simulation import HOST_RNG_OFFSET_P2
from repro_torch.fl.task import Task
from repro_torch.kernels import ops
from repro_torch.launch.mesh import all_gather_into, reduce_scatter_into
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device
from repro_torch.utils.flatten import (FlatView, put_runs, take_runs,
                                      torch_dtype)

Pytree = Any

POD_ALGORITHMS = ("fedavg", "fedprox", "scaffold", "moon")
POD_AGGREGATIONS = ("sequential", "hierarchical")
POD_TASK_KINDS = ("vision", "charlm", "tokenlm")

_VARIANTS = {"fedavg": "plain", "fedprox": "fedprox",
             "scaffold": "scaffold", "moon": "moon"}

# the collectives this module issues, by purpose: "grad" (per SGD step:
# one all-reduce per batch axis for each replicated bucket, and for each
# bucket sharded over mesh axes the reduce-scatter over its batch axes
# plus one all-reduce per batch axis it is not sharded on), "gather" (one
# all-gather per sharded bucket each time the model's whole leaves are
# formed: every step's loss, trainable and frozen, each eval, the
# anchors of fedprox and moon, the result), "clip" (one all-reduce per
# distinct axis set of the sharded buckets per global norm: the step's
# clip norm and DP's delta clip), "batch" (losses and eval sums, once per
# chunk), "lane_combine" (one per bucket per hierarchical round),
# "store_gather" (one per leaf per round of a client store sharded over
# data), "store_spill" (one per leaf per commit that evicts live rows of
# a sharded sparse store), "tp" (the all-reduces over ``model`` of a
# tensor-parallel step, ``sharding.tensor_parallel``: per block the
# row-parallel outputs forward and the column-parallel inputs backward,
# the vocabulary's embedding and cross-entropy, the gradients of the
# leaves whose model ranks compute different parts), "moe" (an MoE
# layer's collectives over the batch group of a step whose batch is
# split: per layer forward the per-expert counts' all-gather, the aux
# loss's sums, the dispatch buffer's reduce-scatter and the experts'
# output's all-gather; backward the aux sums, the output's
# reduce-scatter and the buffer's all-gather).  COLLECTIVE_BYTES holds
# the bytes each kind received on this rank.
_KINDS = ("grad", "gather", "clip", "batch", "lane_combine",
          "store_gather", "store_spill", "tp", "moe")
COLLECTIVES: Dict[str, int] = dict.fromkeys(_KINDS, 0)
COLLECTIVE_BYTES: Dict[str, int] = dict.fromkeys(_KINDS, 0)


def reset_collective_counts() -> None:
    for k in _KINDS:
        COLLECTIVES[k] = 0
        COLLECTIVE_BYTES[k] = 0


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += int(nbytes)


def _all_reduce(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Sum ``t`` in place over ``group``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count(kind, t.numel() * t.element_size())
    return t


def _batch_all_reduce(t: torch.Tensor, mesh, kind: str) -> torch.Tensor:
    """Sum ``t`` in place over the batch group (pod, data): one
    all-reduce per batch axis of the mesh."""
    for axis in rules.batch_axes(mesh):
        _all_reduce(t, mesh.group(axis), kind)
    return t


def _batch_shards(mesh) -> int:
    """The size of the batch group (pod, data)."""
    return math.prod(mesh.axis_size(a) for a in rules.batch_axes(mesh))


def batch_mean_(tensors, mesh) -> None:
    """Each tensor averaged over the batch group (pod, data) in place: one
    all-reduce per batch axis each, counted as "grad"."""
    shards = _batch_shards(mesh)
    for t in tensors:
        _batch_all_reduce(t, mesh, "grad")
        if shards > 1:
            t.div_(shards)


def gather_dim(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The whole of a tensor of which this rank holds block ``dim`` of
    the ranks over mesh ``axes`` (row-major): one all-gather over them,
    counted as "gather"."""
    axes = tuple(axes)
    n = math.prod(mesh.axis_size(a) for a in axes)
    full = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    all_gather_into(full.reshape(-1), t.contiguous().reshape(-1),
                     mesh.group(axes))
    _count("gather", full.numel() * full.element_size())
    shape = list(t.shape)
    shape[dim] *= n
    return full.movedim(0, dim).reshape(shape)


@dataclasses.dataclass(frozen=True)
class PodFLSpec:
    """Static description of one pod-scale federated round."""
    local_steps: int = 8            # t_i — SGD steps per client
    batch_size: int = 8             # B — per-step batch over the mesh
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    algorithm: str = "fedavg"       # fedavg | fedprox | scaffold | moon
    mu: float = 0.01
    temperature: float = 0.5
    grad_clip: Optional[float] = None
    server_opt: str = "none"        # none | momentum | adam
    server_lr: float = 1.0
    server_momentum: float = 0.9
    update_impl: str = "tree"       # tree | fused | fused_interpret
    dp: Optional[privacy.DPSpec] = None
    secure_agg: bool = False
    compression: Optional[compression.CompressionSpec] = None
    # the trainable slice (see LocalSpec); P1 strips both knobs — the
    # relay hops the full model
    peft: Optional[str] = None
    trainable_filter: Optional[str] = None

    def __post_init__(self):
        validate_update_impl(self.update_impl)
        if self.algorithm not in POD_ALGORITHMS:
            raise ValueError(f"unknown pod algorithm {self.algorithm!r}")
        compression.validate_compression(
            self.compression, dp=self.dp, secure_agg=self.secure_agg)
        if compression.compression_on(self.compression) and \
                self.update_impl == "tree":
            raise ValueError(
                "pod lossy compression needs the fused flat path "
                "(update_impl='fused'|'fused_interpret') — the tree "
                "backend has no shard-local compress kernel")
        validate_peft(self.peft, trainable_filter=self.trainable_filter,
                      update_impl=self.update_impl)

    def local_spec(self, variant: Optional[str] = None) -> LocalSpec:
        return LocalSpec(
            n_steps=self.local_steps, batch_size=self.batch_size, lr=self.lr,
            momentum=self.momentum, weight_decay=self.weight_decay,
            variant=variant or _VARIANTS[self.algorithm], mu=self.mu,
            temperature=self.temperature, grad_clip=self.grad_clip,
            update_impl=self.update_impl, dp=self.dp,
            secure_agg=self.secure_agg, compression=self.compression,
            peft=self.peft, trainable_filter=self.trainable_filter)


# ---------------------------------------------------------------------------
# client-state store sharded over the mesh data axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientRows:
    """This rank's rows of a client-state stack: clients ``[lo, lo +
    per)`` when the client axis shards over ``data``, plus one scratch
    row that takes the writes of clients it does not own; all
    ``n_clients`` rows otherwise."""
    rows: Pytree
    lo: int
    per: int
    sharded: bool


@dataclasses.dataclass(frozen=True)
class ShardedClientStateStore(DenseClientStateStore):
    """Per-client state stacks with the client axis sharded over the mesh
    ``data`` axis (``rules.client_axis_pspec``: replicated when the
    client count does not divide it, or ``whole``).  No host read of
    the ids: owned rows are selected on the device."""
    mesh: Any = None

    def init(self, template: Pytree, n_clients: int,
             whole: bool = False) -> ClientRows:
        """The stack of ``template`` rows.  ``whole`` (the template's rows
        differ over ``data``: ``ShardedFlatOps.varies_over``) keeps the
        client axis whole: every rank holds every client's rows of its
        own shards, and a gather is a local index — an all-reduce over
        ``data`` would sum different shards.  (Held per rank, that is the
        memory of a client axis sharded over ``data``.)"""
        spec = rules.client_axis_pspec(self.mesh, 1, n_clients)
        if spec[0] is None or whole:
            return ClientRows(rows=super().init(template, n_clients), lo=0,
                              per=n_clients, sharded=False)
        per = n_clients // self.mesh.axis_size(rules.DATA)
        lo = self.mesh.coords[rules.DATA] * per
        return ClientRows(rows=super().init(template, per + 1), lo=lo,
                          per=per, sharded=True)

    def _local(self, state: ClientRows, ids: torch.Tensor):
        owned = (ids >= state.lo) & (ids < state.lo + state.per)
        return owned, torch.where(owned, ids - state.lo,
                                  torch.full_like(ids, state.per))

    def gather(self, state: ClientRows, ids: torch.Tensor) -> Pytree:
        if not state.sharded:
            return super().gather(state.rows, ids)
        owned, li = self._local(state, ids)
        group = self.mesh.group(rules.DATA)

        def one(s):
            rows = s.index_select(0, li)
            mask = owned.reshape((-1,) + (1,) * (rows.dim() - 1))
            rows = torch.where(mask, rows, torch.zeros_like(rows))
            return _all_reduce(rows, group, "store_gather")
        return tm.tree_map(one, state.rows)

    def scatter(self, state: ClientRows, ids: torch.Tensor,
                rows: Pytree) -> ClientRows:
        """Write the owned clients' ``rows`` in place (the others land in
        the scratch row)."""
        if not state.sharded:
            super().scatter(state.rows, ids, rows)
            return state
        _, li = self._local(state, ids)
        super().scatter(state.rows, li, rows)
        return state

    def population(self, state: ClientRows) -> int:
        if not state.sharded:
            return state.per
        return state.per * self.mesh.axis_size(rules.DATA)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSparseClientStateStore(SparseClientStateStore):
    """The sparse store on the mesh: the table's ``capacity`` slot axis
    shards over ``data`` as ``ShardedClientStateStore`` shards clients
    (replicated when the capacity does not divide it, or ``whole`` as
    in ``ShardedClientStateStore.init``).  Each rank holds
    its block of slots plus a scratch row; a gather (and a spill) is one
    ``all_reduce`` per leaf of the owned rows, a scatter and a refill
    write the owned slots.  The id→slot index, the LRU state, the host
    mirrors and the spill dict replicate: every rank plans the same
    residency from the same ids and keeps every spilled row, so a client
    may refault into a slot another rank owns."""
    mesh: Any = None

    def _table_rows(self, cap: int, whole: bool) -> int:
        spec = rules.client_axis_pspec(self.mesh, 1, cap)
        if spec[0] is None or whole:
            self._meta.update(sharded=False, lo=0, per=cap)
            return cap
        per = cap // self.mesh.axis_size(rules.DATA)
        self._meta.update(sharded=True, per=per,
                          lo=self.mesh.coords[rules.DATA] * per)
        return per + 1

    def _local(self, slots: torch.Tensor):
        lo, per = self._meta["lo"], self._meta["per"]
        owned = (slots >= lo) & (slots < lo + per)
        return owned, torch.where(owned, slots - lo,
                                  torch.full_like(slots, per))

    def _rows_at(self, state, slots: torch.Tensor,
                 kind: Optional[str] = "store_gather"):
        """One all_reduce per leaf of the owned rows at ``slots``,
        counted under ``kind`` (None: uncounted)."""
        if not self._meta["sharded"]:
            return super()._rows_at(state, slots, kind)
        owned, li = self._local(slots)
        group = self.mesh.group(rules.DATA)

        def one(t):
            rows = t.index_select(0, li)
            mask = owned.reshape((-1,) + (1,) * (rows.dim() - 1))
            rows = torch.where(mask, rows, torch.zeros_like(rows))
            if kind is None:
                dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
                return rows
            return _all_reduce(rows, group, kind)
        return tm.tree_map(one, state["table"])

    def _write_rows(self, state, slots: torch.Tensor, rows) -> None:
        """The owned slots' rows (the others land in the scratch row)."""
        if not self._meta["sharded"]:
            return super()._write_rows(state, slots, rows)
        self._write_local(state, self._local(slots)[1], rows)

    def _refill_targets(self, victims):
        if not self._meta["sharded"]:
            return super()._refill_targets(victims)
        lo, per = self._meta["lo"], self._meta["per"]
        return (victims >= lo) & (victims < lo + per), victims - lo


# ---------------------------------------------------------------------------
# sharded flat ops — the pod's flat-first representation
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """The model's trainable leaves from this rank's rows under a
    :class:`_Layout`: the forward all-gathers each bucket over the
    layout's axes into its ``whole`` buffers; the backward hands each
    bucket's row its gradient, reduced over the batch group once
    (``ShardedFlatOps._row_grad``)."""

    @staticmethod
    def forward(ctx, ops, layout, names, *rows):
        ctx.ops, ctx.layout, ctx.names = ops, layout, names
        ctx.widths = tuple(r.shape[-1] for r in rows)
        whole = ops._gather(dict(zip(names, rows)), layout)
        ctx.whole_names = tuple(whole)
        return tuple(whole.values())

    @staticmethod
    def backward(ctx, *grads):
        ops, layout = ctx.ops, ctx.layout
        whole = {}
        for name, g in zip(ctx.whole_names, grads):
            whole[name] = g if g is not None else torch.zeros(
                layout.whole.buffer_sizes[name], dtype=torch_dtype(name),
                device=ops.device)
        return (None, None, None) + tuple(
            ops._row_grad(name, whole, w, layout)
            for name, w in zip(ctx.names, ctx.widths))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """How the model's leaves are formed from the rows: ``view`` is a
    ShardedFlatView over the rows' elements whose ``whole_view()`` is the
    leaves' layout (``whole``), and ``parts[bucket]`` lists the view's
    buckets ``(part, runs)`` that a row splits into: the part's
    ``(offset, size)`` runs of the row (None: the whole row).  The plain
    layout gathers every bucket over all its axes; the tensor-parallel
    one keeps the local leaves' ``model`` tile
    (``ShardedFlatView.model_local``)."""
    view: Any
    parts: Dict[str, tuple]

    @functools.cached_property
    def whole(self) -> FlatView:
        return self.view.whole_view()


@dataclasses.dataclass(frozen=True)
class ShardedFlatOps(FlatParamOps):
    """FlatParamOps over this rank's rows of the ``ShardedFlatView``
    buckets (``view`` is their per-shard layout, ``local_view``).

    Every kernel runs on the rank's own row with no collective: K1, K6,
    K3, the compressed upload (top-k keeps k of the PER-SHARD population,
    ``_logical_size``) and K5.  The collectives sit around the model:
    :meth:`unflatten` all-gathers each sharded bucket over its axes into
    whole leaves (trainable ones through ``_GatherRows``, whose backward
    reduce-scatters the gradient back to the row), and the global clip
    norm sums each bucket's Σg² over its axes (:meth:`grad_sqsum`).
    ``split_batch`` says whether each rank computes its own part of the
    batch (the gradient then reduces over the batch group).

    With ``tp`` (a ``sharding.tensor_parallel.TPContext``: the
    ``fsdp_tp`` layout on a ``model`` axis larger than 1, of any arch
    whose plan splits a part) the step computes tensor-parallel, under
    every algorithm: its loss runs on the model-local tree
    (:meth:`tp_tree`), gathered over each bucket's axes other than
    ``model`` for the leaves that keep their ``model`` tile and over all
    its axes for the rest; FedProx's anchor is the same model-local tree
    of the round's start rows (:meth:`prox_anchor`).  MOON's anchors,
    the eval and the result still gather whole leaves."""
    sharded: Any = None             # the ShardedFlatView
    mesh: Any = None
    split_batch: bool = False
    tp: Any = None                  # TPContext, or None

    @functools.cached_property
    def whole(self) -> FlatView:
        """The whole leaves' layout (``ShardedFlatView.whole_view``)."""
        return self.sharded.whole_view()

    @functools.cached_property
    def _plain(self) -> _Layout:
        return _Layout(self.sharded, {g.name: ((g.name, None),)
                                      for g in self.sharded.groups})

    @functools.cached_property
    def _tp_layout(self) -> _Layout:
        shapes = tm.tree_unflatten(self.sharded.treedef,
                                   [0] * len(self.sharded.slots))
        view, parts = self.sharded.model_local(
            [self.tp.local(p) for p in tm.tree_paths(shapes)], rules.MODEL)
        return _Layout(view, parts)

    @functools.cached_property
    def _coords(self) -> Dict[str, int]:
        return dict(self.mesh.coords)

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        return self.sharded.flatten_local(tree, self._coords)

    def flatten_frozen(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """This rank's rows of the ``frozen:`` groups, placed by
        ``rules.frozen_flat_shardings``: never replicated beyond its
        group."""
        return self.sharded.flatten_local(tree, self._coords, frozen=True)

    def normal(self, key: int) -> Dict[str, torch.Tensor]:
        return self.pad(self.sharded.normal_local(key, self._coords,
                                                  self.device))

    def varies_over(self, axis: str) -> bool:
        """Whether a trainable bucket's rows differ over mesh ``axis``."""
        return any(axis in g.axes for g in self.sharded.trainable_groups)

    @functools.cached_property
    def row_reduced(self) -> frozenset:
        """The trainable buckets whose gradient the gather's backward has
        already reduced over the batch group (``_row_grad``): those
        sharded over mesh axes, when the batch is split.  The rest is
        ``grad_reducer``'s."""
        if not self.split_batch:
            return frozenset()
        return frozenset(g.name for g in self.sharded.trainable_groups
                         if g.axes)

    # -- the model's leaves ------------------------------------------------

    def _gather(self, rows: Dict[str, torch.Tensor], layout: _Layout
                ) -> Dict[str, torch.Tensor]:
        """The ``layout.whole`` buffers of the buckets ``rows`` (this
        rank's rows, padded or not): one all-gather per part of a bucket
        over the part's axes, counted as "gather" with its bytes."""
        view = layout.view
        whole = {n: torch.empty(layout.whole.all_sizes[n],
                                dtype=torch_dtype(n), device=self.device)
                 for n in self._whole_names(rows, layout)}
        for name, row in rows.items():
            row = row.detach()
            for part, runs in layout.parts[name]:
                g = view.group_map[part]
                sub = row[:g.size] if runs is None else take_runs(row, runs)
                if g.axes:
                    full = torch.empty((g.n_shards, sub.shape[-1]),
                                       dtype=sub.dtype, device=sub.device)
                    all_gather_into(full.reshape(-1), sub.contiguous(),
                                    self.mesh.group(g.axes))
                    _count("gather", full.numel() * full.element_size())
                else:
                    full = sub.reshape(1, -1)
                view.rows_to_whole(part, full, whole)
        return whole

    def _row_grad(self, name: str, whole: Dict[str, torch.Tensor],
                  width: int, layout: _Layout) -> torch.Tensor:
        """This rank's row gradient (``width`` wide, zero past the size) of
        bucket ``name`` from the leaves' gradient buffers ``whole``, part
        by part (:meth:`_part_grad`)."""
        reduce = bool(self.sharded.group_map[name].axes)
        parts = layout.parts[name]
        if len(parts) == 1 and parts[0][1] is None:
            part = parts[0][0]
            return self._part_grad(layout.view, part, layout.view
                                   .whole_to_rows(part, whole, width), reduce)
        out = None
        for part, runs in parts:
            G = layout.view.whole_to_rows(part, whole)
            g = self._part_grad(layout.view, part, G, reduce)
            if out is None:
                out = g.new_zeros(width)
            put_runs(out, runs, g)
        return out

    def _part_grad(self, view, name: str, G: torch.Tensor,
                   reduce: bool) -> torch.Tensor:
        """This rank's row of part ``name`` from the leaves' gradient rows
        ``G`` ``(n_shards, width)``.  Every element sums exactly once
        over the batch group (pod, data) and never over ``model``: a
        ``model`` rank holds either its tile's own gradient (a local leaf
        of a tensor-parallel step) or the same whole gradient as the
        other ``model`` ranks (its model ranks computed the same batch
        part, or the step summed a leaf whose ranks computed different
        parts of it: ``tensor_parallel.TPContext.partial``), so the
        part's ``model`` axis is sliced at this rank's coordinate, its
        batch axes reduce-scattered, and the batch axes it is not sharded
        on all-reduced; then the batch mean.  A bucket not sharded over
        mesh axes (``reduce`` False) returns its one row:
        ``grad_reducer`` reduces it as on any layout."""
        if not reduce:
            return G[0]
        mesh, width = self.mesh, G.shape[-1]
        if not self.split_batch:        # every rank computed the batch
            return G[view.local_rows(self._coords)[name]].clone()
        baxes = rules.batch_axes(mesh)
        own, G = self._batch_rows(view, name, G)
        if own:
            out = torch.empty(width, dtype=G.dtype, device=G.device)
            reduce_scatter_into(out, G.contiguous().reshape(-1),
                                mesh.group(own))
            _count("grad", out.numel() * out.element_size())
        else:
            out = G[0].clone()
        for a in baxes:
            if a not in own:
                _all_reduce(out, mesh.group(a), "grad")
        shards = _batch_shards(mesh)
        return out.div_(shards) if shards > 1 else out

    def _batch_rows(self, view, name: str, G: torch.Tensor):
        """``(own, rows)``: the batch axes part ``name`` of ``view`` is
        sharded on (mesh order), and the rows of ``G`` ``(n_shards,
        width)`` at this rank's coordinates on its other axes — one row
        per shard of ``own``, row-major, the order of the group over
        ``own``."""
        axes, width = view.group_map[name].axes, G.shape[-1]
        own = tuple(a for a in axes if a in rules.batch_axes(self.mesh))
        G = G.reshape(tuple(self.mesh.axis_size(a) for a in axes) +
                      (width,))
        return own, G[tuple(slice(None) if a in own else self._coords[a]
                            for a in axes)].reshape(-1, width)

    def _leaves(self, bufs, frozen, layout: _Layout) -> Pytree:
        wf = (self._gather(frozen, layout) if frozen
              else layout.whole.frozen_zeros(self.device))
        if torch.is_grad_enabled() and any(b.requires_grad
                                           for b in bufs.values()):
            names = tuple(bufs)
            out = _GatherRows.apply(self, layout, names, *bufs.values())
            wb = dict(zip(self._whole_names(names, layout), out))
        else:
            with torch.no_grad():
                wb = self._gather(bufs, layout)
        return layout.whole.unflatten(wb, wf)

    def unflatten(self, bufs: Dict[str, torch.Tensor],
                  frozen: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Pytree:
        """The tree from this rank's rows, gathered over each bucket's
        axes (the ``frozen`` rows too, without a gradient; zero when
        absent).  When a row requires grad, the leaves carry the
        gradient back to the rows through ``_GatherRows``; under ``tp``
        that tree is the step's model-local one (:meth:`tp_tree`).  The
        gathered copy lives as long as the tree: one step.  With every
        bucket replicated (a one-rank mesh, the replicated layout) the
        leaves are views of the rows, as on the host."""
        if not any(g.axes for g in self.sharded.groups):
            return super().unflatten(bufs, frozen)
        if self.tp is not None and torch.is_grad_enabled() and any(
                b.requires_grad for b in bufs.values()):
            return self.tp_tree(bufs, frozen)
        return self._leaves(bufs, frozen, self._plain)

    def tp_tree(self, bufs: Dict[str, torch.Tensor],
                frozen: Optional[Dict[str, torch.Tensor]] = None
                ) -> Pytree:
        """The model-local tree of a tensor-parallel step
        (``tensor_parallel.TPParams``): each local leaf its ``model``
        tile, whole over the other axes, the rest whole."""
        from repro_torch.sharding.tensor_parallel import TPParams
        return TPParams(self._leaves(bufs, frozen, self._tp_layout), self.tp)

    def prox_anchor(self, bufs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """FedProx's anchor: the trainable leaves of the round's start
        rows, by path, gathered as the step's tree has them (under
        ``tp`` model-local; no gradient), which the proximal term reads
        leaf for leaf beside the step's (``tensor_parallel.
        squared_distance``).  The frozen leaves are not gathered: they
        never move in a round."""
        if not any(g.axes for g in self.sharded.groups):
            return super().prox_anchor(bufs)
        layout = self._plain if self.tp is None else self._tp_layout
        with torch.no_grad():
            return layout.whole.trainable_by_path(self._gather(bufs,
                                                               layout))

    def _whole_names(self, names, layout: _Layout) -> List[str]:
        seen = {n.partition("@")[0] for n in names}
        return [n for n in layout.whole.all_sizes if n in seen]

    # -- the global norms: one all-reduce per axis set --------------------

    def _sum_over_axes(self, parts: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        """Σ of per-bucket local sums, each summed over the mesh axes its
        bucket is sharded on (never over the replicas): one all-reduce
        per distinct axis set, counted as "clip"."""
        by_axes: Dict[tuple, torch.Tensor] = {}
        for name, v in parts.items():
            axes = self.sharded.group_map[name].axes
            by_axes[axes] = by_axes[axes] + v if axes in by_axes else v
        total = None
        for axes, v in by_axes.items():
            if axes:
                v = _all_reduce(v.reshape(1).clone(),
                                self.mesh.group(axes), "clip").reshape(())
            total = v if total is None else total + v
        return total

    def grad_sqsum(self, g_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._sum_over_axes({name: torch.dot(g, g)
                                    for name, g in g_bufs.items()})

    def delta_sqnorm(self, w_bufs, p_bufs) -> torch.Tensor:
        return self._sum_over_axes({
            name: privacy.flat_delta_sqnorm({name: w}, p_bufs)
            for name, w in w_bufs.items()})

    def stacked_empty(self, K: int):
        raise NotImplementedError("the pod backend aggregates "
                                  "sequentially — no stacked buffers")

    def weighted_delta(self, p_bufs, stacked_bufs, wbar, extra=None, *,
                       deltas: bool = False):
        raise NotImplementedError("the pod backend aggregates "
                                  "sequentially — use delta_accum")

    # -- hierarchical lanes: one owned p-free partial, one all-reduce ------

    def lane_count(self) -> int:
        """Pod lanes the mesh hosts one per rank (= |data| axis)."""
        return rules.mesh_axis_size(self.mesh, rules.DATA)

    def lane_index(self) -> int:
        """The lane this rank owns: its ``data`` coordinate."""
        return self.mesh.coords.get(rules.DATA, 0)

    def lane_zeros(self, G: int) -> Dict[str, torch.Tensor]:
        """The owned lane's f32 zero partial."""
        if G != self.lane_count():
            raise ValueError(f"lane layout needs n_pods == |data| axis "
                             f"({G} != {self.lane_count()})")
        return self.zeros(torch.float32)

    def lane_accum(self, acc_bufs, w_bufs, coeff) -> Dict[str, torch.Tensor]:
        """``acc += coeff·w`` on the owned lane, in place: the accum-only
        K6 per bucket, no collective."""
        return self.delta_accum(acc_bufs, w_bufs, None, coeff)

    def lane_combine(self, acc_bufs) -> Dict[str, torch.Tensor]:
        """The single cross-pod combine: one ``all_reduce`` over the mesh
        ``data`` axis per bucket, in place; every rank gets the total."""
        group = self.mesh.group(rules.DATA)
        for acc in acc_bufs.values():
            _all_reduce(acc, group, "lane_combine")
        return acc_bufs


@functools.lru_cache(maxsize=32)
def _sharded_view(task: Task, mesh, layout: str,
                  filter_spec: Optional[str] = None):
    """The task's ShardedFlatView on ``mesh`` (split by ``filter_spec``)
    and its per-shard layout."""
    view = rules.sharded_flat_view(param_shapes(task), mesh, layout,
                                   filter_spec)
    return view, view.local_view()


@functools.lru_cache(maxsize=32)
def _sharded_flat_ops(task: Task, mesh, layout: str, interpret: bool,
                      filter_spec: Optional[str] = None,
                      split_batch: bool = False) -> ShardedFlatOps:
    sharded, local = _sharded_view(task, mesh, layout, filter_spec)
    return ShardedFlatOps(view=local, interpret=interpret,
                          device=mesh.device, sharded=sharded, mesh=mesh,
                          split_batch=split_batch,
                          tp=_tp_context(task, mesh, layout))


def _tp_context(task: Task, mesh, layout: str):
    """The ``fsdp_tp`` layout's tensor-parallel context of a task with a
    model config (``sharding.tensor_parallel.context``), else None."""
    from repro_torch.sharding import tensor_parallel
    if layout != "fsdp_tp" or task.model_cfg is None:
        return None
    return tensor_parallel.context(task.model_cfg, mesh)


# ---------------------------------------------------------------------------
# the pod backend (engine hooks shared by both strategies)
# ---------------------------------------------------------------------------

class PodBackendMixin:
    """Engine backend hooks for a mesh.  Subclasses are frozen strategy
    dataclasses providing ``mesh``, ``layout`` and ``clients_per_round``
    fields."""

    def _check_device(self, device: torch.device) -> None:
        device, own = torch.device(device), self.mesh.device
        if device.type != own.type or device.index not in (None, own.index):
            raise ValueError(f"the pod runs on its mesh's device "
                             f"{self.mesh.device}, not {device}")

    def flat_ops(self, task: Task, device: torch.device):
        self._check_device(device)
        if task.kind not in POD_TASK_KINDS:
            raise ValueError(f"unknown task kind {task.kind!r} (the pod "
                             f"runs {POD_TASK_KINDS})")
        if self.spec.update_impl == "tree":
            return None
        # every algorithm's step computes tensor-parallel where the layout
        # and the arch allow (FedProx's anchor is the model-local tree:
        # ShardedFlatOps.prox_anchor); MOON's anchors, the eval and the
        # result gather whole leaves
        return _sharded_flat_ops(
            task, self.mesh, self.layout,
            ops.fused_interpret(self.spec.update_impl),
            effective_trainable_filter(self.spec),
            self.batch_shard(self.spec.batch_size) is not None)

    def n_selected(self, n_clients: int) -> int:
        if self.clients_per_round:
            return max(1, min(self.clients_per_round, n_clients))
        return super().n_selected(n_clients)

    def batch_shard(self, n: int) -> Optional[slice]:
        """This rank's contiguous part of a batch of ``n`` over (pod,
        data) — row-major over those axes, as ``rules.fl_batch_pspec``
        shards it — or None when the group does not divide ``n`` (every
        rank computes the whole batch).  A one-rank group takes the
        whole batch as its part, so its collectives still run."""
        shards = _batch_shards(self.mesh)
        if n % shards or n < shards:
            return None
        per = n // shards
        i = self.mesh.index(rules.batch_axes(self.mesh))
        return slice(i * per, (i + 1) * per)

    def task_over_batch(self, task: Task, n: int) -> Task:
        """``task`` whose model functions get the batch group
        (``sharding.batch_group``) with their params, when the task's
        model has MoE layers and a batch of ``n`` splits over more than
        one rank: each layer then takes its capacity, its slots and its
        aux loss over the whole batch, as the JAX pod's global batch
        does — in the steps of both update paths, MOON's anchors and the
        eval."""
        from repro_torch.sharding import batch_group as bgl
        cfg = task.model_cfg
        bg = bgl.batch_group(self.mesh) if (
            cfg is not None and cfg.is_moe and
            self.batch_shard(n) is not None) else None
        if bg is None:
            return task
        on = functools.partial(bgl.on_batch_group, bg=bg)
        return dataclasses.replace(
            task,
            loss_fn=lambda p, bx, by, rng=None: task.loss_fn(on(p), bx, by,
                                                             rng),
            repr_fn=lambda p, bx: task.repr_fn(on(p), bx),
            predict_fn=lambda p, bx: task.predict_fn(on(p), bx))

    def reduce_over_batch(self, t: torch.Tensor, n: int, *,
                          mean: bool) -> torch.Tensor:
        if self.batch_shard(n) is None:
            return t
        t = _batch_all_reduce(t.clone(), self.mesh, "batch")
        shards = _batch_shards(self.mesh)
        return t / shards if mean and shards > 1 else t

    def grad_reducer(self, fops: Optional[ShardedFlatOps] = None
                     ) -> Optional[Callable[[Pytree], Pytree]]:
        """The gradient mean over the batch group (pod, data): one
        all-reduce per leaf (a tree's leaf or a fused bucket), in place;
        None when every rank computes the whole batch.  The fused buckets
        of ``fops.row_reduced`` are skipped: the gather's backward
        reduced them."""
        if self.batch_shard(self.spec.batch_size) is None:
            return None
        mesh = self.mesh
        skip = fops.row_reduced if fops is not None else frozenset()

        def reduce(grads):
            left = ([g for name, g in grads.items() if name not in skip]
                    if skip else grads)
            batch_mean_(tm.tree_leaves(left), mesh)
            return grads
        return reduce

    def prepare_eval_data(self, batched, device: torch.device):
        """The eval stream with each batch's sample axis split over
        (pod, data) like the training batch; the sums reduce over the
        group (``reduce_over_batch``)."""
        ev = super().prepare_eval_data(batched, device)
        part = self.batch_shard(ev[0].shape[1])
        return ev if part is None else tuple(a[:, part] for a in ev)


@dataclasses.dataclass(frozen=True)
class PodRelayStrategy(PodBackendMixin, RelayStrategy):
    """P1 relay on the mesh: the host relay body (clients in order, no
    aggregation) with the batch data-parallel over the mesh."""
    mesh: Any = None
    layout: str = "fsdp_tp"
    clients_per_round: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()         # relay rejects dp/secure_agg
        if self.mesh is None:
            raise ValueError("PodRelayStrategy requires a mesh")


@dataclasses.dataclass(frozen=True)
class PodAggregateStrategy(PodBackendMixin, AggregateStrategy):
    """P2 on the mesh: clients one after another, each accumulated into a
    round-owned f32 delta (K6), error-feedback rows behind a
    data-axis-sharded store, server optimizers as on the host.
    ``aggregation`` "sequential" or "hierarchical" (``n_pods`` lanes,
    default the mesh's ``data`` size; see the module doc)."""
    mesh: Any = None
    layout: str = "fsdp_tp"
    clients_per_round: Optional[int] = None
    aggregation: str = "sequential"     # sequential | hierarchical
    n_pods: Optional[int] = None        # None: mesh data-axis size

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("PodAggregateStrategy requires a mesh")
        if self.algorithm not in POD_ALGORITHMS:
            raise ValueError(f"unknown pod algorithm {self.algorithm!r}")
        if self.aggregation not in POD_AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r} "
                             f"(choose from {POD_AGGREGATIONS})")
        if self.state_store is DENSE_STORE:
            object.__setattr__(self, "state_store",
                               ShardedClientStateStore(mesh=self.mesh))
        super().__post_init__()

    def _init_rows(self, store, template: Pytree, n_clients: int,
                   fops: Optional[ShardedFlatOps]) -> Any:
        """A stack of rows that differ over ``data`` keeps its client axis
        whole (``ShardedClientStateStore.init``)."""
        return store.init(template, n_clients, whole=(
            fops is not None and fops.varies_over(rules.DATA)))

    def _n_pods(self) -> int:
        if self.n_pods:
            return int(self.n_pods)
        return max(1, rules.mesh_axis_size(self.mesh, rules.DATA))

    def build_round(self, task: Task, device: torch.device) -> Callable:
        spec = self.spec
        fops = self.flat_ops(task, device)
        local = make_local_fn(self.task_over_batch(task, spec.batch_size),
                              spec, fops, self.grad_reducer(fops))
        fused = fops is not None
        ef_store = self._ef_store
        G = self._n_pods() if self.aggregation == "hierarchical" else 1
        dp = spec.dp
        dp_clips = dp is not None and dp.clips
        comp = spec.compression
        compressed = compression.compression_on(comp)   # fused (PodFLSpec)
        ef = compressed and comp.error_feedback
        # the owned-lane partial needs the same rows on every data rank:
        # a bucket sharded over data keeps all G lanes
        lane_psum = fused and G > 1 and G == fops.lane_count() and \
            not fops.varies_over(rules.DATA)

        def to_device(tree):
            return tm.tree_map(lambda x: torch.as_tensor(x).to(
                device=device, dtype=torch.float32), tree)

        def body(params, inputs, lr_scale, algo_state):
            K = inputs.ids.shape[0]
            if G > 1 and K % G:
                raise ValueError(
                    f"hierarchical aggregation needs clients_per_round "
                    f"divisible by n_pods (K={K}, n_pods={G})")
            w32 = inputs.weights.to(torch.float32)
            wsum = torch.sum(w32)
            # every client's coefficient w_j/Σw in one division per round:
            # coef[j] is a view, so nothing is issued between a client's
            # last kernel and its K6, which may then stage early (PDL)
            coef = w32 / wsum
            ef_rows = (ef_store.gather(algo_state["ef_residuals"],
                                       inputs.ids) if ef else None)
            extras_of, update = self.client_state(fops, params, inputs.ids,
                                                  lr_scale, algo_state,
                                                  inputs.frozen)

            if fused:
                work = fops.zeros()         # one client's working params

                def zeros_delta():
                    return fops.zeros(torch.float32)

                def run_client(j):
                    for name, b in work.items():
                        b.copy_(params[name])
                    return local(work, inputs.sampler(j), lr_scale,
                                 extras_of(j), inputs.frozen)

                def add_delta(delta, w_end, c):
                    return fops.delta_accum(delta, w_end, params, c)

                sqnorm = fops.delta_sqnorm
            else:
                def zeros_delta():
                    return tm.tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device), params)

                def run_client(j):
                    return local(params, inputs.sampler(j), lr_scale,
                                 extras_of(j))

                def add_delta(delta, w_end, c):
                    return tm.tree_map(
                        lambda d, we, p: d + c * (we.float() - p.float()),
                        delta, w_end, params)

                sqnorm = privacy.tree_delta_sqnorm

            def coeff_of(j, w_end):
                return coef[j]

            if dp_clips:
                # the clip folds into the accumulation coefficient, in this
                # order: (w_j·min(1, C/‖w_end − p‖))/wsum
                def coeff_of(j, w_end):
                    scale = privacy.clip_scale(dp, sqnorm(w_end, params))
                    return (w32[j] * scale) / wsum

            def upload(j, w_end):
                # a compressed upload IS a delta: w_end − p (+ residual)
                d = {name: w_end[name].float() - params[name].float()
                     for name in w_end}
                if ef:
                    d = {name: x + ef_rows[name][j] for name, x in d.items()}
                return fops.compress_delta(d, comp)

            losses: List[torch.Tensor] = []
            r_outs: List[Dict[str, torch.Tensor]] = []
            # scaffold's and moon's state update reads every client's end
            # state (the fused path reuses one working buffer: copies)
            ends: List[Pytree] = []

            def client(j):
                w_end, loss = run_client(j)
                losses.append(loss)
                if self.algorithm in ("scaffold", "moon"):
                    ends.append(tm.tree_map(torch.clone, w_end) if fused
                                else w_end)
                if not compressed:
                    return w_end, None
                c, r_new = upload(j, w_end)
                r_outs.append(r_new)
                return w_end, c

            if lane_psum:
                me = fops.lane_index()
                acc = fops.lane_zeros(G)
                csum = torch.zeros((), dtype=torch.float32, device=device)
                for s in range(K // G):
                    coeffs = []
                    for g in range(G):
                        j = s * G + g
                        w_end, c = client(j)
                        if dp_clips and not compressed:
                            coeff = coef[j] * privacy.clip_scale(
                                dp, sqnorm(w_end, params))
                            coeffs.append(coeff)
                        else:
                            coeff = coef[j]
                        if g == me:
                            fops.lane_accum(acc, c if compressed else w_end,
                                            coeff)
                    if coeffs:
                        csum = csum + torch.sum(torch.stack(coeffs))
                acc = fops.lane_combine(acc)
                if compressed:
                    delta = acc
                elif dp_clips:
                    delta = {name: a - csum * params[name].float()
                             for name, a in acc.items()}
                else:
                    # Σᵢ cᵢ = 1: the −(Σc)·p term is −p, applied once
                    delta = {name: a - params[name].float()
                             for name, a in acc.items()}
            else:
                accs = [zeros_delta() for _ in range(G)]
                for j in range(K):          # step j // G, lane j % G
                    w_end, c = client(j)
                    g = j % G
                    if compressed:
                        fops.delta_accum(accs[g], c, None, coef[j])
                    else:
                        accs[g] = add_delta(accs[g], w_end,
                                            coeff_of(j, w_end))
                delta = accs[0]
                for a in accs[1:]:          # the one cross-lane sum
                    delta = tm.tree_map(torch.add, delta, a)

            # DP noise + secure-agg masks: once per round, every topology
            if fused:
                normal_fn = inputs.normal_fn(
                    fops.normal,
                    lambda tree: fops.pad(fops.flatten(to_device(tree))))
            else:
                normal_fn = inputs.normal_fn(
                    lambda key: privacy.tree_normal(key, params, device),
                    to_device)
            drawn = (dp is not None and dp.noised) or spec.secure_agg
            extra = privacy.round_extra(
                dp, spec.secure_agg, inputs.id_list() if drawn else [],
                coef, zeros_fn=zeros_delta, normal_fn=normal_fn)
            if extra is not None:
                delta = tm.tree_map(torch.add, delta, extra)

            if fused:
                new_params = fops.apply_delta(
                    {name: p.clone() for name, p in params.items()}, delta)
            else:
                new_params = tm.tree_map(
                    lambda p, d: (p.float() + d).to(p.dtype), params, delta)

            state = update(tm.tree_map(lambda *xs: torch.stack(xs), *ends)
                           if ends else None)
            if ef:
                rows = {name: torch.stack([r[name] for r in r_outs])
                        for name in r_outs[0]}
                state = dict(state, ef_residuals=ef_store.scatter(
                    algo_state["ef_residuals"], inputs.ids, rows))
            return new_params, state, torch.stack(losses).mean()

        return body


# ---------------------------------------------------------------------------
# declarative phase configs (core.pipeline entries)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodCyclicConfig:
    """P1 relay phase on the pod backend."""
    mesh: Any
    rounds: int = 4
    clients_per_round: int = 4
    spec: PodFLSpec = PodFLSpec()
    layout: str = "fsdp_tp"
    lr_decay: float = 1.0
    eval_every: int = 0
    eval_batch: int = 64
    seed: int = 0
    chunk_size: int = 4
    sampling: str = "device"        # device | host
    # (round, client_slot, step) -> LongTensor (B,): replaces the
    # engine's generator draws for the batch indices
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def strategy(self) -> PodRelayStrategy:
        return PodRelayStrategy(
            spec=self.spec.local_spec("plain"), mesh=self.mesh,
            layout=self.layout, clients_per_round=self.clients_per_round)

    def schedule(self) -> RoundSchedule:
        return RoundSchedule(
            rounds=self.rounds, lr_decay=self.lr_decay,
            eval_every=self.eval_every, eval_batch=self.eval_batch,
            seed=self.seed, chunk_size=self.chunk_size,
            sampling=self.sampling, host_rng_offset=HOST_RNG_OFFSET_P1,
            batch_indices=self.batch_indices)


@dataclasses.dataclass(frozen=True)
class PodFLConfig:
    """P2 aggregation phase on the pod backend (algorithm from spec)."""
    mesh: Any
    rounds: int = 4
    clients_per_round: int = 4
    spec: PodFLSpec = PodFLSpec()
    layout: str = "fsdp_tp"
    lr_decay: float = 1.0
    eval_every: int = 0
    eval_batch: int = 64
    seed: int = 0
    chunk_size: int = 4
    sampling: str = "device"
    aggregation: str = "sequential"     # sequential | hierarchical
    n_pods: Optional[int] = None
    store: str = "dense"                # dense | sparse
    store_capacity: int = 1024          # the sparse table's rows
    overlap: bool = True                # pipeline residency behind compute
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def strategy(self) -> PodAggregateStrategy:
        kwargs = {}
        if self.store == "sparse":
            kwargs["state_store"] = ShardedSparseClientStateStore(
                capacity=self.store_capacity, mesh=self.mesh)
        elif self.store != "dense":
            raise ValueError(f"unknown store {self.store!r} "
                             f"(choose from ('dense', 'sparse'))")
        return PodAggregateStrategy(
            spec=self.spec.local_spec(), algorithm=self.spec.algorithm,
            server_opt=self.spec.server_opt, server_lr=self.spec.server_lr,
            server_momentum=self.spec.server_momentum,
            mesh=self.mesh, layout=self.layout,
            clients_per_round=self.clients_per_round,
            aggregation=self.aggregation, n_pods=self.n_pods, **kwargs)

    def schedule(self) -> RoundSchedule:
        return RoundSchedule(
            rounds=self.rounds, lr_decay=self.lr_decay,
            eval_every=self.eval_every, eval_batch=self.eval_batch,
            seed=self.seed, chunk_size=self.chunk_size,
            sampling=self.sampling, host_rng_offset=HOST_RNG_OFFSET_P2,
            overlap=self.overlap, batch_indices=self.batch_indices)


def run_pod_rounds(task: Task, data: FederatedDataset, cfg,
                   init_params: Optional[Pytree] = None,
                   ledger=None, verbose: bool = False,
                   eval_fn: Optional[Callable] = None,
                   switch_policy=None, phase: str = "P2",
                   device: Device = None):
    """Phase runner for the pod configs — the engine loop does the work,
    on the mesh's device (``device``, when given, must be it)."""
    dev = cfg.mesh.device if device is None else resolve_device(device)
    strategy = cfg.strategy()
    return run_rounds(task, data, strategy, cfg.schedule(),
                      init_params=init_params, ledger=ledger, verbose=verbose,
                      eval_fn=eval_fn, switch_policy=switch_policy,
                      phase=phase, label=f"pod-{strategy.name}", device=dev)


# register with the declarative schedule so Phase(cfg=Pod*Config) works
from repro_torch.core.pipeline import register_phase_runner  # noqa: E402

register_phase_runner(PodCyclicConfig, "relay", run_pod_rounds)
register_phase_runner(PodFLConfig, "aggregate", run_pod_rounds)
