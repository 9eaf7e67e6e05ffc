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
    ``ShardedFlatView`` buckets (``ShardedFlatOps``).  The paper's
    vision models replicate under every layout, so the rank's row of
    each bucket is the whole bucket and every kernel runs on it as on
    one device.  A bucket sharded over mesh axes (the LLM trees on a
    world larger than one) needs all_gather/reduce_scatter around the
    model: ROADMAP.md item M13b.
  * Per-client state (scaffold's control variates, moon's previous
    local models, the error-feedback rows of compressed uploads) lives
    in a ``ShardedClientStateStore`` whose client axis shards over
    ``data``: each rank holds its block of rows, a gather is one
    ``all_reduce`` of a zero-filled ``(K, N)`` buffer into which each
    owner writes its rows (exact), a scatter writes the owned rows.
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
``COLLECTIVES``); ``−(Σcoeff)·p`` applies once after it.  Otherwise
each rank keeps all G lane accumulators and sums them.  Either way the
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

Not ported yet, each raising ``NotImplementedError`` naming its item:
sharded groups on a world larger than one (M13b; trainable and frozen
alike), and AOT lowering of the pod round (M15).
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
                                  not_ported, param_shapes, validate_peft,
                                  validate_update_impl)
from repro_torch.fl.simulation import HOST_RNG_OFFSET_P2
from repro_torch.fl.task import Task
from repro_torch.kernels import ops
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device

Pytree = Any

POD_ALGORITHMS = ("fedavg", "fedprox", "scaffold", "moon")
POD_AGGREGATIONS = ("sequential", "hierarchical")
POD_TASK_KINDS = ("vision", "charlm", "tokenlm")

_VARIANTS = {"fedavg": "plain", "fedprox": "fedprox",
             "scaffold": "scaffold", "moon": "moon"}

# the collectives this module issues, by purpose: "grad" (one per bucket
# per SGD step), "batch" (losses and eval sums, once per chunk),
# "lane_combine" (one per bucket per hierarchical round), "store_gather"
# (one per leaf per round of a sharded client store), "store_spill" (one
# per leaf per commit that evicts live rows of a sharded sparse store)
COLLECTIVES: Dict[str, int] = {"grad": 0, "batch": 0, "lane_combine": 0,
                               "store_gather": 0, "store_spill": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _all_reduce(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Sum ``t`` in place over ``group``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES[kind] += 1
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
    client count does not divide it).  No host read of the ids: owned
    rows are selected on the device."""
    mesh: Any = None

    def init(self, template: Pytree, n_clients: int) -> ClientRows:
        spec = rules.client_axis_pspec(self.mesh, 1, n_clients)
        if spec[0] is None:
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
    (replicated when the capacity does not divide it).  Each rank holds
    its block of slots plus a scratch row; a gather (and a spill) is one
    ``all_reduce`` per leaf of the owned rows, a scatter and a refill
    write the owned slots.  The id→slot index, the LRU state, the host
    mirrors and the spill dict replicate: every rank plans the same
    residency from the same ids and keeps every spilled row, so a client
    may refault into a slot another rank owns."""
    mesh: Any = None

    def _table_rows(self, cap: int) -> int:
        spec = rules.client_axis_pspec(self.mesh, 1, cap)
        if spec[0] is None:
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

@dataclasses.dataclass(frozen=True)
class ShardedFlatOps(FlatParamOps):
    """FlatParamOps over this rank's rows of the ``ShardedFlatView``
    buckets (``view`` is their local layout).  Every kernel runs on the
    rank's own buffer with no collective; the lane methods carry the
    hierarchical aggregation."""
    sharded: Any = None             # the ShardedFlatView
    mesh: Any = None

    def _rows(self, full: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        rows = self.sharded.local_rows(self.mesh.coords)
        return {name: b[rows[name]] for name, b in full.items()}

    def flatten(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        return self._rows(self.sharded.flatten(tree))

    def flatten_frozen(self, tree: Pytree) -> Dict[str, torch.Tensor]:
        """This rank's rows of the ``frozen:`` groups, placed by
        ``rules.frozen_flat_shardings``."""
        return self._rows(self.sharded.flatten_frozen(tree))

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
    """The task's ShardedFlatView on ``mesh`` (split by ``filter_spec``);
    raises (M13b) when a bucket, trainable or frozen, is sharded over
    mesh axes."""
    view = rules.sharded_flat_view(param_shapes(task), mesh, layout,
                                   filter_spec)
    return view, view.local_view()


@functools.lru_cache(maxsize=32)
def _sharded_flat_ops(task: Task, mesh, layout: str, interpret: bool,
                      filter_spec: Optional[str] = None) -> ShardedFlatOps:
    sharded, local = _sharded_view(task, mesh, layout, filter_spec)
    return ShardedFlatOps(view=local, interpret=interpret,
                          device=mesh.device, sharded=sharded, mesh=mesh)


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
        filt = effective_trainable_filter(self.spec)
        _sharded_view(task, self.mesh, self.layout, filt)   # M13b check
        if self.spec.update_impl == "tree":
            return None
        return _sharded_flat_ops(task, self.mesh, self.layout,
                                 ops.fused_interpret(self.spec.update_impl),
                                 filt)

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

    def reduce_over_batch(self, t: torch.Tensor, n: int, *,
                          mean: bool) -> torch.Tensor:
        if self.batch_shard(n) is None:
            return t
        t = _batch_all_reduce(t.clone(), self.mesh, "batch")
        shards = _batch_shards(self.mesh)
        return t / shards if mean and shards > 1 else t

    def grad_reducer(self) -> Optional[Callable[[Pytree], Pytree]]:
        """The gradient mean over the batch group (pod, data): one
        all-reduce per leaf (a tree's leaf or a fused bucket), in place;
        None when every rank computes the whole batch."""
        if self.batch_shard(self.spec.batch_size) is None:
            return None
        mesh, shards = self.mesh, _batch_shards(self.mesh)

        def reduce(grads):
            for g in tm.tree_leaves(grads):
                _batch_all_reduce(g, mesh, "grad")
                if shards > 1:
                    g.div_(shards)
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

    def _n_pods(self) -> int:
        if self.n_pods:
            return int(self.n_pods)
        return max(1, rules.mesh_axis_size(self.mesh, rules.DATA))

    def build_round(self, task: Task, device: torch.device) -> Callable:
        spec = self.spec
        fops = self.flat_ops(task, device)
        local = make_local_fn(task, spec, fops, self.grad_reducer())
        fused = fops is not None
        ef_store = self._ef_store
        G = self._n_pods() if self.aggregation == "hierarchical" else 1
        dp = spec.dp
        dp_clips = dp is not None and dp.clips
        comp = spec.compression
        compressed = compression.compression_on(comp)   # fused (PodFLSpec)
        ef = compressed and comp.error_feedback
        lane_psum = fused and G > 1 and G == fops.lane_count()

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

                sqnorm = privacy.flat_delta_sqnorm
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


def make_pod_fl_round(*args, **kwargs):
    """The AOT-lowerable pod round of the JAX package's dry run."""
    not_ported("make_pod_fl_round", "M15")


def lower_pod_round(*args, **kwargs):
    """Lowering of the pod round for compile analysis."""
    not_ported("lower_pod_round", "M15")


# register with the declarative schedule so Phase(cfg=Pod*Config) works
from repro_torch.core.pipeline import register_phase_runner  # noqa: E402

register_phase_runner(PodCyclicConfig, "relay", run_pod_rounds)
register_phase_runner(PodFLConfig, "aggregate", run_pod_rounds)
