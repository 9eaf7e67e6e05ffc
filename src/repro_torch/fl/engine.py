"""The federated round engine — ONE driver for both CyclicFL phases.

The counterpart of ``repro/fl/engine.py`` on the host backend, with a
synchronous round loop.  A ``RoundStrategy`` decides what a round is:

  RelayStrategy     : P1 — the model hops client → client through the
                      selected clients in order, NO aggregation.
  AggregateStrategy : P2 — K independent local runs from the same start
                      (one after another, client k's end state written
                      into row k of a ``(K, N)`` stack), then the
                      weighted FedAvg mean and an optional server
                      optimizer (FedAvgM / FedAdam); the algorithm is
                      fedavg, fedprox, scaffold or moon, the last two
                      with per-client state rows (control variates,
                      previous local models) in a
                      :class:`DenseClientStateStore`.

Both the per-step client update and the per-round aggregation/server
step run as per-leaf tree algebra (``update_impl="tree"``) or
FLAT-FIRST (``"fused"``/``"fused_interpret"``): params and server
moments ride the rounds as padded FlatParamOps buffers on the device,
and every update stage is one kernel per bucket
(``repro_torch.kernels.fused_update``).  Trees exist only as views at
the model's forward/backward boundary, at eval, and in the
:class:`EngineResult`.

Per round the engine keeps every traced scalar on the device — the lr
scale, the client weights, the clip scale, the Adam bias corrections —
and reads the losses and metrics back once per chunk.  A chunk of
``chunk_size`` rounds is one call of the chunk function, so
``EngineResult.dispatches`` is ``ceil(rounds / chunk_size)`` as in the
JAX package (a switch policy pins the chunk to one round).

Randomness: ``sampling="host"`` draws client ids from
``np.random.default_rng(seed + host_rng_offset)`` exactly as the JAX
package does; ``sampling="device"`` uses ``torch.randperm`` on a device
generator (see below).  Batch indices come from a ``torch.Generator`` on the device
seeded from ``schedule.seed``, or from ``schedule.batch_indices`` —
``(round, client_slot, step) -> LongTensor (B,)`` — when it is set (the
parity tests inject the JAX package's threefry draws through it).  Each
step's dropout source, the loss's ``rng``, is a ``torch.Generator`` on
the device seeded with ``fold_in`` of the seed, round, client slot and
step (no step waits on the host), or the keep-mask that
``schedule.step_masks`` — ``(round, client_slot, step) -> mask`` —
gives when it is set (the parity tests inject the JAX package's
``bernoulli`` draws through it).  A model without dropout ignores it.

P2 also runs compressed uploads (``spec.compression``,
``repro_torch.fl.compression``: per-client error-feedback residual rows
in a :class:`DenseClientStateStore`) and DP-FedAvg / secure aggregation
(``spec.dp``, ``spec.secure_agg``, ``repro_torch.fl.privacy``), on the
tree and the fused paths.  The privacy draws are keyed by round and
client id (``RoundInputs.round_key`` and the ids on the host, which
both sampling modes know when the chunk is planned), or come from ``schedule.noise_draws`` when it is set (the parity
tests inject the JAX package's threefry draws through it).
``schedule.on_aggregate`` sees each P2 aggregate's inputs, start
buffers, stacked client end states and new params (``chip_smoke.py``
rebuilds a private round's uploads from them).

A trainable slice (``spec.peft`` / ``spec.trainable_filter``, fused
paths, P2 only) makes every buffer above the trainable buckets only;
the frozen buckets are packed and placed once per phase, never padded
or handed to a kernel, and reach each round as ``RoundInputs.frozen``,
merged into the model at the loss and the eval.  The ledger's upload is
then the slice's bytes.

Per-client state rows live in a store: :class:`DenseClientStateStore`
(an ``(n_clients, ...)`` stack on the device) or
:class:`SparseClientStateStore` (a ``capacity``-row table of the
clients a dispatch touches, the others spilled to host memory).  The
sparse store manages residency between dispatches from the chunk's
client ids on the host; ``RoundSchedule.overlap`` pipelines that work,
planning and staging chunk N+1 while chunk N runs on the device
(``EngineResult.timing`` has the split).  Under ``sampling="device"``
each round's ids come from a generator of their own, seeded with
``fold_in(seed, _IDS_TAG, round)``, drawn when the chunk is planned
(on a side stream on CUDA, read back behind an event), so the host
knows them without waiting on a chunk in flight.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import compression, privacy
from repro_torch.fl.local import (
    FlatParamOps,
    LocalSpec,
    Sample,
    effective_trainable_filter,
    host_flat_ops,
    make_local_fn,
    param_shapes,
)
from repro_torch.fl.task import Task
from repro_torch.kernels import ops
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import (Device, fold_in, resolve_device,
                                      seeded_generator)
from repro_torch.utils.flatten import FlatView, torch_dtype

Pytree = Any

ALGORITHMS = ("fedavg", "fedprox", "scaffold", "moon")
SERVER_OPTS = ("none", "momentum", "adam")

# folded into the seed of each step's dropout generator ("drop")
_DROPOUT_TAG = 0x64726F70
# folded into the seed of each round's client-id generator ("ids")
_IDS_TAG = 0x696473

# FedAdam (server_opt="adam") moment decays — shared by the tree
# optimizer, the fused kernel call and its bias-correction scalars
SERVER_ADAM_B1 = 0.9
SERVER_ADAM_B2 = 0.99


def fused_aggregate(fops: FlatParamOps, p_bufs: Dict, stacked_bufs: Dict,
                    weights: torch.Tensor) -> Dict:
    """FedAvg aggregation on the flat path: the stacked ``(K, N)``
    client buffers are aggregated by one ``weighted_delta`` kernel per
    bucket, with the normalized weights kept on the device."""
    wbar = (weights / torch.sum(weights)).to(torch.float32)
    return fops.weighted_delta(p_bufs, stacked_bufs, wbar)


@functools.lru_cache(maxsize=64)
def _logical_model_bytes(task: Task) -> int:
    """X for the comm ledger: the LOGICAL model bytes from the task's
    param shapes — never the padded carried buffers."""
    return tm.size_bytes(param_shapes(task))


@functools.lru_cache(maxsize=64)
def _upload_payload_bytes(task: Task, comp,
                          filter_spec: Optional[str] = None) -> int:
    """Closed-form wire bytes of ONE client's upload over the task's
    logical TRAINABLE flat bucket sizes (compressed when ``comp`` is
    lossy, else the dtype bytes of every bucket).  Under a trainable
    filter the frozen leaves never reach the wire."""
    from repro_torch.sharding import rules
    shapes = param_shapes(task)
    view = FlatView.of(shapes,
                       filter=rules.trainable_mask(shapes, filter_spec))
    if compression.compression_on(comp):
        return compression.payload_bytes(comp,
                                         tuple(view.buffer_sizes.values()))
    return int(sum(torch_dtype(name).itemsize * size
                   for name, size in view.buffer_sizes.items()))


def unpack_server_state(fops: FlatParamOps, state: Any) -> Any:
    """Materialize a flat server OptState's moment buffers back into
    param-shaped trees (the EngineResult boundary)."""
    from repro_torch.optim.optimizers import AdamWState, OptState
    if not isinstance(state, OptState):
        return state
    inner = state.inner
    if isinstance(inner, AdamWState):
        inner = AdamWState(mu=fops.unflatten(inner.mu),
                           nu=fops.unflatten(inner.nu))
    elif isinstance(inner, dict) and inner:
        inner = fops.unflatten(inner)
    return OptState(step=state.step, inner=inner)


@dataclasses.dataclass
class RoundInputs:
    """What one round's body reads besides the carried state."""
    ids: torch.Tensor                       # (K,) client ids, on device
    weights: torch.Tensor                   # (K,) f32 n_real of those
    sampler: Callable[[int], Sample]        # client slot -> sample(step)
    round_key: int = 0                      # seed of the privacy draws
    # (kind, a, b) -> f32 param-shaped tree: replaces the keyed draws
    draws: Optional[Callable[[str, int, Optional[int]], Pytree]] = None
    host_ids: Optional[List[int]] = None    # the ids on the host, if known
    # (inputs, params, stacked, new_params) -> None, after the aggregate
    on_aggregate: Optional[Callable[..., None]] = None
    # the phase's read-only frozen buckets (a trainable filter's), merged
    # into the model at the loss; None without a filter
    frozen: Optional[Dict[str, torch.Tensor]] = None

    def id_list(self) -> List[int]:
        """The client ids as host integers (the privacy draws are keyed
        by them); read from the device once when not known."""
        if self.host_ids is None:
            self.host_ids = [int(i) for i in self.ids.tolist()]
        return self.host_ids

    def normal_fn(self, draw: Callable[[int], Pytree],
                  from_tree: Callable[[Pytree], Pytree]) -> privacy.NormalFn:
        """The round's ``normal_fn`` in one representation: ``draw(seed)``
        at the keyed seeds, or the injected ``draws`` through
        ``from_tree``."""
        if self.draws is None:
            return privacy.keyed_normal_fn(self.round_key, draw)
        return lambda kind, a, b=None: from_tree(self.draws(kind, a, b))


@dataclasses.dataclass(frozen=True)
class DenseClientStateStore:
    """Per-client state rows as dense device stacks, ``(n_clients, ...)``
    per leaf: scaffold's control variates, moon's previous local models
    and the error-feedback residual rows of compressed uploads.  Every
    row is always resident: no residency work between dispatches."""

    needs_host_ids = False

    def init(self, template: Pytree, n_clients: int) -> Pytree:
        return tm.tree_map(lambda t: t.unsqueeze(0).expand(
            (n_clients,) + tuple(t.shape)).clone(), template)

    def gather(self, state: Pytree, ids: torch.Tensor) -> Pytree:
        return tm.tree_map(lambda s: s.index_select(0, ids), state)

    def scatter(self, state: Pytree, ids: torch.Tensor,
                rows: Pytree) -> Pytree:
        """Write ``rows`` into the clients' rows, in place."""
        for s, r in zip(tm.tree_leaves(state), tm.tree_leaves(rows)):
            s.index_copy_(0, ids, r)
        return state

    def population(self, state: Pytree) -> int:
        """The number of clients (scaffold's K/N counts all of them)."""
        return tm.tree_leaves(state)[0].shape[0]

    def prepare_chunk(self, state: Pytree, ids_block) -> Pytree:
        return state                    # dense rows are always resident


DENSE_STORE = DenseClientStateStore()


_SPILL_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _spill_pool() -> concurrent.futures.ThreadPoolExecutor:
    """One background worker shared by every sparse store: spill blocks
    land in host memory OFF the engine thread.  A single worker
    serializes them, so at most one competes with the dispatching
    thread for the interpreter."""
    global _SPILL_POOL
    if _SPILL_POOL is None:
        _SPILL_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="spill-materialize")
    return _SPILL_POOL


class _SpillBlock:
    """One commit's evicted rows on their way to host memory.  On CUDA
    ``rows`` are pinned host tensors that a non-blocking device→host
    copy on the store's side stream fills, and ``ready`` the event
    recorded after it; the background worker (:meth:`materialize_async`)
    waits on that event — never on the whole device — and moves the rows
    into pageable memory, giving the pinned block back.  By the time a
    refault needs the rows, :meth:`leaves` just joins the (usually
    finished) worker."""

    __slots__ = ("rows", "ready", "_host", "_future")

    def __init__(self, rows: List[torch.Tensor], ready=None):
        self.rows = rows                # (n_evicted, ...) host leaves
        self.ready = ready              # torch.cuda.Event, or None
        self._host: Optional[List[torch.Tensor]] = None
        self._future = None

    def materialize_async(self, meta: Optional[dict] = None) -> None:
        """Land the rows on the shared worker; ``meta`` (the owning
        store's ``_meta``) accumulates the worker's ms under
        ``"spill_ms"`` — one writer, the pool's one thread."""
        if self._future is None and self._host is None:
            self._future = _spill_pool().submit(self._materialize, meta)

    def _materialize(self, meta: Optional[dict]) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        if self.ready is not None:
            self.ready.synchronize()
        out = [torch.empty(r.shape, dtype=r.dtype).copy_(r)
               for r in self.rows]
        if meta is not None:
            meta["spill_ms"] = meta.get("spill_ms", 0.0) + \
                (time.perf_counter() - t0) * 1e3
        self._host, self.rows, self.ready = out, None, None
        return out

    def leaves(self) -> List[torch.Tensor]:
        if self._future is not None:
            self._future.result()       # join the background copy
            self._future = None
        if self._host is None:
            self._materialize(None)
        return self._host


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index vector on ``device`` as int64, non-blocking (callers
    enqueue it on the store's side stream on CUDA)."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(
        device, non_blocking=True)


def _on_stream(side):
    """``torch.cuda.stream(side)``, or nothing on the CPU (``side`` None),
    where every op is synchronous."""
    return (torch.cuda.stream(side) if side is not None
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True, eq=False)
class SparseClientStateStore:
    """Participation-indexed per-client state: a bounded table of the
    active clients instead of a population stack.

    The state is ``{"table", "slot_of", "owner", "stamp"}`` on the
    device: ``table`` stacks ``capacity`` rows of the per-client
    template, ``slot_of`` is the ``(n_clients,)`` id→slot index (−1:
    cold), ``owner`` / ``stamp`` the ``(capacity,)`` slot→id map and LRU
    clock.  gather / scatter index rows by slot on the device, in place
    like the dense store — O(capacity) device memory however large the
    population.  Residency is managed between dispatches in two halves:

      stage_chunk(ids_block) -> staged   (host planning, refill copy)
      commit_chunk(state, staged) -> state  (the splice, enqueued)

    :meth:`stage_chunk` plans against HOST MIRRORS of the index (kept in
    ``_meta``), so it never reads — and never waits on — the state of a
    dispatch in flight: the overlapped loop stages dispatch N+1 while
    dispatch N runs.  Cold participants fault in from the spill dict
    (free slots first, then the least recently used ones are evicted);
    the refill rows are stacked into a pinned staging buffer (two of
    them, used in turns, each rewritten only after its last copy's
    event) and copied to the device non-blocking on a side stream.
    :meth:`commit_chunk` makes the main stream wait on that copy,
    gathers the evicted live rows from the LATEST table on the main
    stream (so rows the previous dispatch wrote spill with their
    updates), copies them to pinned host memory on the side stream
    behind an event, and splices the refill rows and the index updates
    in place — nothing blocks.  :meth:`prepare_chunk` composes the two
    for the synchronous path.  ``spill=False`` drops evicted rows
    instead: the forgetful mode, where a refault comes back as the
    template.

    ``capacity`` must cover the distinct participants of one dispatch
    (``chunk_size × K`` in the worst case); stage_chunk raises
    otherwise.  The eager members (spill dict, mirrors, staging buffers)
    make the store identity-hashed (``eq=False``)."""

    capacity: int
    spill: bool = True
    _cold: dict = dataclasses.field(default_factory=dict, repr=False)
    _meta: dict = dataclasses.field(default_factory=dict, repr=False)

    needs_host_ids = True

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("SparseClientStateStore capacity must be >= 1")

    # -- the table on the device ---------------------------------------------

    def _table_rows(self, cap: int, whole: bool) -> int:
        """Rows of this process's table (the sharded flavor holds its
        block of slots plus a scratch row, unless ``whole``)."""
        return cap

    def init(self, template: Pytree, n_clients: int,
             whole: bool = False) -> Pytree:
        """The table of ``template`` rows (``whole``: every slot on every
        process, where a flavor would shard them; a process here always
        holds every slot)."""
        leaves, treedef = tm.tree_flatten(template)
        dev = leaves[0].device
        cap = max(1, min(self.capacity, n_clients))
        self._cold.clear()
        self._meta.clear()
        self._meta.update(
            treedef=treedef, device=dev,
            template=[t.detach().to("cpu", copy=True) for t in leaves],
            # host mirrors of the residency index: stage_chunk plans
            # against these, never against the device state
            slot_of=np.full((n_clients,), -1, np.int64),
            owner=np.full((cap,), -1, np.int64),
            stamp=np.zeros((cap,), np.int64),
            stage_bufs=[None, None], stage_turn=0,
            side=torch.cuda.Stream(dev) if dev.type == "cuda" else None,
            transfer_ms=0.0, spill_ms=0.0, spilled=0, refaulted=0)
        rows = self._table_rows(cap, whole)
        return {
            "table": tm.tree_map(lambda t: t.detach().unsqueeze(0).expand(
                (rows,) + tuple(t.shape)).clone(), template),
            "slot_of": torch.full((n_clients,), -1, dtype=torch.int64,
                                  device=dev),
            "owner": torch.full((cap,), -1, dtype=torch.int64, device=dev),
            "stamp": torch.zeros((cap,), dtype=torch.int64, device=dev),
        }

    def _rows_at(self, state: Pytree, slots: torch.Tensor,
                 kind: Optional[str] = "store_gather") -> Pytree:
        """The table's rows at ``slots`` (``kind`` names the collective of
        the sharded flavor)."""
        return tm.tree_map(lambda t: t.index_select(0, slots),
                           state["table"])

    def _write_local(self, state: Pytree, local: torch.Tensor,
                     rows: List[torch.Tensor]) -> None:
        """Write ``rows`` at rows ``local`` of this process's table."""
        for t, r in zip(tm.tree_leaves(state["table"]), rows):
            t.index_copy_(0, local, r)

    def _write_rows(self, state: Pytree, slots: torch.Tensor,
                    rows: List[torch.Tensor]) -> None:
        """Write ``rows`` at ``slots`` (the sharded flavor writes the
        slots it owns)."""
        self._write_local(state, slots, rows)

    def gather(self, state: Pytree, ids: torch.Tensor) -> Pytree:
        # residency is a precondition: the chunk's ids were committed
        return self._rows_at(state, state["slot_of"].index_select(0, ids))

    def scatter(self, state: Pytree, ids: torch.Tensor,
                rows: Pytree) -> Pytree:
        """Write ``rows`` into the clients' slots, in place."""
        self._write_rows(state, state["slot_of"].index_select(0, ids),
                         tm.tree_leaves(rows))
        return state

    def population(self, state: Pytree) -> int:
        """``n_clients``, not ``capacity`` (scaffold's K/N reads it)."""
        return state["slot_of"].shape[0]

    @property
    def staged_transfer_ms(self) -> float:
        """Host ms spent enqueueing refill copies, over the store's life."""
        return float(self._meta.get("transfer_ms", 0.0))

    @property
    def spill_materialize_ms(self) -> float:
        """Background ms landing spilled rows in host memory — work the
        worker does OFF the stage / commit path."""
        return float(self._meta.get("spill_ms", 0.0))

    @property
    def spilled_rows(self) -> int:
        """Rows evicted to host memory, over the store's life."""
        return int(self._meta.get("spilled", 0))

    @property
    def refaulted_rows(self) -> int:
        """Rows faulted back in from host memory, over the store's life."""
        return int(self._meta.get("refaulted", 0))

    # -- host-side residency (between dispatches) ----------------------------

    def _cold_row(self, cid: int, pop: bool = False):
        row = self._cold.pop(cid, None) if pop else self._cold.get(cid)
        if row is None:
            return None
        block, j = row
        return [leaf[j] for leaf in block.leaves()]

    def _refill_targets(self, victims: np.ndarray):
        """Which staged victims this process writes, and the rows of its
        table they land in: all of them here (the sharded flavor writes
        the slots it owns)."""
        return np.ones(victims.shape, bool), victims

    def _stage_rows(self, fill: List[List[torch.Tensor]]):
        """Stack the refill rows into a staging buffer: pinned on CUDA,
        two used in turns and grown geometrically; a buffer is rewritten
        only after the event of its last copy to the device.  Returns
        the rows and the buffer's turn."""
        meta, tmpl = self._meta, self._meta["template"]
        n, turn = len(fill), meta["stage_turn"]
        meta["stage_turn"] = 1 - turn
        slot = meta["stage_bufs"][turn]
        if slot is not None and slot[1] is not None:
            slot[1].synchronize()
        if slot is None or slot[0][0].shape[0] < n:
            rows_cap = max(n, 2 * (slot[0][0].shape[0] if slot else 2))
            pin = meta["device"].type == "cuda"
            slot = ([torch.empty((rows_cap,) + tuple(t.shape), dtype=t.dtype,
                                 pin_memory=pin) for t in tmpl], None)
        for j, row in enumerate(fill):
            for buf, r in zip(slot[0], row):
                buf[j].copy_(r)
        meta["stage_bufs"][turn] = slot
        return [buf[:n] for buf in slot[0]], turn

    def stage_chunk(self, ids_block) -> Dict[str, Any]:
        """Plan residency for the NEXT dispatch and start its refill copy
        — host work against the mirror index and copies on the side
        stream, so it may run while the previous dispatch executes."""
        ids = np.unique(np.asarray(ids_block, np.int64))
        meta = self._meta
        slot_of, owner, stamp = meta["slot_of"], meta["owner"], meta["stamp"]
        cap = owner.shape[0]
        slots_ids = slot_of[ids]
        miss = ids[slots_ids < 0]
        staged: Dict[str, Any] = {"victims": None, "ready": None,
                                  "rows": None}
        host: Dict[str, np.ndarray] = {}
        fill: List[List[torch.Tensor]] = []
        if miss.size:
            resident = slots_ids[slots_ids >= 0]
            cand = np.setdiff1d(np.arange(cap), resident)
            # free slots first, then coldest-first among the owned ones
            order = np.argsort(np.where(owner[cand] < 0, -1, stamp[cand]),
                               kind="stable")
            cand = cand[order]
            if miss.size > cand.size:
                raise ValueError(
                    f"store capacity {cap} cannot hold the {ids.size} "
                    f"distinct clients of the next dispatch "
                    f"({miss.size} cold, {cand.size} evictable slots) — "
                    f"raise the capacity above chunk_size × K")
            # sorted victims keep the refill rows in slot order
            victims = np.sort(cand[:miss.size])
            evicted = owner[victims].copy()
            live = evicted >= 0
            mine, local = self._refill_targets(victims)
            # refill: the spilled row of a client seen before, else the
            # template (every process pops, so the spill dicts agree)
            rows = [self._cold_row(int(cid), pop=True) for cid in miss]
            meta["refaulted"] += sum(r is not None for r in rows)
            rows = [r or meta["template"] for r in rows]
            fill = [r for r, m in zip(rows, mine) if m]
            gone = evicted[live]
            slot_of[gone] = -1
            slot_of[miss] = victims
            owner[victims] = miss
            host.update(victims=victims, miss=miss, gone=gone,
                        spill_slots=victims[live], local=local[mine])
            staged.update(victims=victims, evicted=evicted,
                          n_gone=int(gone.size), spill=bool(live.any()))
        # touch every participant's slot so the LRU order tracks rounds
        touch = int(stamp.max()) + 1
        slots = slot_of[ids]
        stamp[slots] = touch
        host["touch_slots"] = slots.copy()
        staged["touch_value"] = touch

        dev, side = meta["device"], meta["side"]
        t0 = time.perf_counter()
        with _on_stream(side):
            staged["idx"] = {k: _h2d(v, dev) for k, v in host.items()}
            turn = None
            if fill and meta["template"]:
                rows_host, turn = self._stage_rows(fill)
                staged["rows"] = [r.to(dev, non_blocking=True, copy=True)
                                  for r in rows_host]
            if side is not None:
                ready = torch.cuda.Event()
                ready.record(side)
                staged["ready"] = ready
                if turn is not None:
                    bufs = meta["stage_bufs"][turn][0]
                    meta["stage_bufs"][turn] = (bufs, ready)
        meta["transfer_ms"] += (time.perf_counter() - t0) * 1e3
        return staged

    def _spill(self, state: Pytree, spill_slots: torch.Tensor,
               evicted: np.ndarray) -> None:
        """Park the evicted live rows in host memory: their gather from
        the latest table on the main stream, a copy to pinned memory on
        the side stream behind an event, the move to pageable memory on
        the worker."""
        meta = self._meta
        side = meta["side"]
        rows = tm.tree_leaves(self._rows_at(state, spill_slots, "store_spill"))
        ready = None
        if side is not None:
            gathered = torch.cuda.Event()
            gathered.record(torch.cuda.current_stream(meta["device"]))
            side.wait_event(gathered)
            with torch.cuda.stream(side):
                host = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                        .copy_(r, non_blocking=True) for r in rows]
                ready = torch.cuda.Event()
                ready.record(side)
            for r in rows:
                r.record_stream(side)
            rows = host
        block = _SpillBlock(rows, ready)
        block.materialize_async(meta)
        for j, cid in enumerate(evicted[evicted >= 0]):
            self._cold[int(cid)] = (block, j)
        meta["spilled"] += int((evicted >= 0).sum())

    def commit_chunk(self, state: Pytree, staged: Dict[str, Any]) -> Pytree:
        """Apply a staged plan to the device state, in place.  Everything
        is enqueued on the main stream behind the staged copy's event:
        committing on top of a dispatch in flight extends the queue."""
        meta = self._meta
        idx, rows = staged["idx"], staged["rows"]
        if staged["ready"] is not None:
            main = torch.cuda.current_stream(meta["device"])
            main.wait_event(staged["ready"])
            for t in list(idx.values()) + (rows or []):
                t.record_stream(main)
        slot_of, owner = state["slot_of"], state["owner"]
        if staged["victims"] is not None:
            if self.spill and staged["spill"]:
                self._spill(state, idx["spill_slots"], staged["evicted"])
            if rows is not None:
                self._write_local(state, idx["local"], rows)
            if staged["n_gone"]:
                slot_of.index_fill_(0, idx["gone"], -1)
            slot_of.index_copy_(0, idx["miss"], idx["victims"])
            owner.index_copy_(0, idx["victims"], idx["miss"])
        state["stamp"].index_fill_(0, idx["touch_slots"],
                                   staged["touch_value"])
        return state

    def prepare_chunk(self, state: Pytree, ids_block) -> Pytree:
        return self.commit_chunk(state, self.stage_chunk(ids_block))

    # -- parity helper -------------------------------------------------------

    def _full_table(self, state: Pytree) -> List[torch.Tensor]:
        """Every slot's row, leaf by leaf, on the host (on every rank of
        the sharded flavor; uncounted: ``to_dense`` is for tests)."""
        slots = torch.arange(self._meta["owner"].shape[0],
                             device=self._meta["device"])
        return [t.cpu() for t in
                tm.tree_leaves(self._rows_at(state, slots, None))]

    def to_dense(self, state: Pytree) -> Pytree:
        """The full ``(n_clients, ...)`` stack on the table's device: hot
        rows from the table, cold rows from the spill dict, the template
        otherwise — for tests; it defeats the point at scale."""
        slot_of = state["slot_of"].cpu().numpy()
        table = self._full_table(state)
        out = [t.unsqueeze(0).expand((slot_of.shape[0],) + tuple(t.shape))
               .clone() for t in self._meta["template"]]
        for cid, slot in enumerate(slot_of):
            row = ([leaf[slot] for leaf in table] if slot >= 0 else
                   self._cold_row(int(cid)))
            if row is not None:
                for o, r in zip(out, row):
                    o[cid] = r
        dev = self._meta["device"]
        return tm.tree_unflatten(self._meta["treedef"],
                                 [o.to(dev) for o in out])


class HostBackend:
    """Backend hooks of the single-device engine.  ``run_rounds`` calls
    them where the JAX engine does; the pod backend
    (``repro_torch.fl.pod.PodBackendMixin``) overrides them."""

    def flat_ops(self, task: Task, device: torch.device
                 ) -> Optional[FlatParamOps]:
        """The flat-buffer representation, or None on the tree path."""
        if self.spec.update_impl == "tree":
            return None
        return host_flat_ops(task, ops.fused_interpret(self.spec.update_impl),
                             torch.device(device),
                             effective_trainable_filter(self.spec))

    def n_selected(self, n_clients: int) -> int:
        return max(1, int(round(self.participation * n_clients)))

    def place_params(self, params: Pytree, device: torch.device) -> Pytree:
        """The tree path's working params: a copy on ``device`` (the
        engine updates in place; the caller's tensors stay untouched)."""
        return tm.tree_map(lambda x: x.detach().to(device, copy=True),
                           params)

    def place_server_state(self, state: Any, task: Task) -> Any:
        return state

    def prepare_data(self, data: FederatedDataset, device: torch.device):
        """``(x_all, y_all, n_real)`` on ``device``."""
        return data.device_arrays(device)

    def prepare_eval_data(self, batched: Tuple, device: torch.device
                          ) -> Tuple:
        """The eval stream ``(ev_x, ev_y, ev_w)`` on ``device``."""
        ev_x, ev_y, ev_w = batched
        return (torch.as_tensor(ev_x).to(device),
                torch.as_tensor(ev_y).to(device=device, dtype=torch.int64),
                torch.as_tensor(ev_w).to(device))

    def grad_reducer(self, fops: Optional[FlatParamOps] = None
                     ) -> Optional[Callable[[Pytree], Pytree]]:
        """The gradient hook between a step's backward and its step tail,
        on the tree and the fused path (``fops`` the fused path's flat
        ops, None on the tree path; the hook None: the identity)."""
        return None

    def batch_shard(self, n: int) -> Optional[slice]:
        """The part of a batch of ``n`` that this process computes (None:
        all of it, and nothing to reduce)."""
        return None

    def task_over_batch(self, task: Task, n: int) -> Task:
        """``task`` as its model functions run on this process's part of
        a batch of ``n`` (the pod's: over the batch group)."""
        return task

    def reduce_over_batch(self, t: torch.Tensor, n: int, *,
                          mean: bool) -> torch.Tensor:
        """Combine per-process values of a batch of ``n`` (losses: mean;
        eval sums: sum) — the identity on one device."""
        return t

    def prepare_chunk_state(self, algo_state: Dict, ids_block) -> Dict:
        """Residency for a chunk whose client ids are ``ids_block``, run
        before the chunk by a store that needs them (the composition of
        the two hooks below); a no-op by default."""
        return algo_state

    def stage_chunk_state(self, ids_block) -> Any:
        """First half: host planning and staged copies only, no read of
        the device state — safe while the previous chunk runs.  Returns
        a token for :meth:`commit_chunk_state` (None: nothing to do)."""
        return None

    def commit_chunk_state(self, algo_state: Dict, staged: Any) -> Dict:
        """Second half: splice a staged plan into the state on the
        device, enqueue-only."""
        return algo_state


# a single round's source of batch indices: an int seed, or
# (client_slot, step) -> LongTensor (B,)
RoundKey = Union[int, Callable[[int, int], torch.Tensor]]


def keyed_sampler(key: RoundKey, x_all, y_all, ids: torch.Tensor,
                  batch: int, device: torch.device,
                  step_masks: Optional[Callable[[int, int], torch.Tensor]]
                  = None) -> Callable[[int], Sample]:
    """The sampler of a single-round surface (``simulation.make_round_fn``,
    ``cyclic.make_cyclic_round_fn``) over ``(n_clients, n_per, ...)``
    client arrays: client slot → ``sample(step)``.  An int ``key`` seeds
    the torch.Generator on ``device`` that draws the batch indices; a
    callable ``key(slot, step)`` gives them instead (the parity tests
    inject the reference's draws through it).  Each step's dropout
    source is a generator on ``device`` seeded with ``fold_in`` of the
    int key (0 for a callable one), the client slot and the step, or
    the keep-mask ``step_masks(slot, step)`` gives when it is set."""
    x_all = torch.as_tensor(x_all).to(device)
    y_all = torch.as_tensor(y_all).to(device)
    seed = 0 if callable(key) else key
    gen = None if callable(key) else seeded_generator(key, device)
    step_gen = seeded_generator(0, device)

    def for_slot(slot: int) -> Sample:
        cx, cy = x_all[ids[slot]], y_all[ids[slot]]

        def sample(step: int):
            if gen is None:
                idx = key(slot, step).to(device=device, dtype=torch.int64)
            else:
                idx = torch.randint(0, cx.shape[0], (batch,), generator=gen,
                                    device=device)
            if step_masks is not None:
                rng = step_masks(slot, step).to(device)
            else:
                step_gen.manual_seed(fold_in(seed, _DROPOUT_TAG, slot, step))
                rng = step_gen
            return cx.index_select(0, idx), cy.index_select(0, idx), rng
        return sample
    return for_slot


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RelayStrategy(HostBackend):
    """P1 — Algorithm 1's sequential relay: the carried model IS the
    relay, updated in place client after client."""
    spec: LocalSpec
    participation: float = 0.25

    name = "relay"

    def __post_init__(self):
        # P1 has no aggregation: nothing to clip, noise or mask
        if self.spec.dp is not None or self.spec.secure_agg:
            raise ValueError("RelayStrategy (P1) has no aggregation; "
                             "dp/secure_agg apply to P2 only")
        # ... and the relayed model is the next client's start state, so
        # a lossy upload would corrupt training, not just the aggregate
        if compression.compression_on(self.spec.compression):
            raise ValueError("RelayStrategy (P1) relays the model itself; "
                             "lossy compression applies to P2 round "
                             "deltas only")
        # ... and the relay hops the FULL model: a trainable-slice filter
        # would freeze most of what P1 exists to pre-train
        if self.spec.peft is not None or \
                self.spec.trainable_filter is not None:
            raise ValueError("RelayStrategy (P1) relays the full model; "
                             "peft/trainable_filter applies to P2 rounds "
                             "only")

    def init_state(self, task: Task, params: Pytree, n_clients: int) -> Dict:
        return {}

    def make_server_update(self, task: Task, device: torch.device):
        return None

    def build_round(self, task: Task, device: torch.device) -> Callable:
        fops = self.flat_ops(task, device)
        local = make_local_fn(
            self.task_over_batch(task, self.spec.batch_size), self.spec,
            fops, self.grad_reducer(fops))

        def body(params, inputs: RoundInputs, lr_scale, algo_state):
            losses = []
            for slot in range(inputs.ids.shape[0]):
                params, loss = local(params, inputs.sampler(slot), lr_scale,
                                     None, inputs.frozen)
                losses.append(loss)
            return params, algo_state, torch.stack(losses).mean()

        return body

    def record(self, ledger, k: int, params: Pytree, task: Task) -> None:
        ledger.record_cyclic_round(k, params,
                                   x_bytes=_logical_model_bytes(task))


@dataclasses.dataclass(frozen=True)
class AggregateStrategy(HostBackend):
    """P2 — one federated round: K local runs from the same start, the
    weighted FedAvg mean, and an optional server optimizer."""
    spec: LocalSpec
    algorithm: str = "fedavg"
    participation: float = 0.1
    server_opt: str = "none"        # none | momentum | adam
    server_lr: float = 1.0
    server_momentum: float = 0.9
    state_store: Any = DENSE_STORE  # dense, or SparseClientStateStore

    # the key each algorithm keeps its per-client rows under
    _STORE_KEYS = {"scaffold": "c_clients", "moon": "w_prev"}

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(f"unknown server_opt {self.server_opt!r}")
        if not all(hasattr(self.state_store, m) for m in
                   ("init", "gather", "scatter", "population")):
            raise ValueError(f"state_store {self.state_store!r} is not a "
                             f"client-state store (init, gather, scatter, "
                             f"population)")

    @property
    def name(self) -> str:
        return self.algorithm

    @property
    def _ef(self) -> bool:
        comp = self.spec.compression
        return compression.compression_on(comp) and comp.error_feedback

    @functools.cached_property
    def _ef_store(self):
        """A FRESH store instance for the error-feedback rows: a sparse
        store keeps residency state per table (host mirrors, the spill
        dict), so the algorithm's rows and the residual rows cannot share
        one.  A dense store is stateless and serves both."""
        store = self.state_store
        if isinstance(store, SparseClientStateStore):
            return dataclasses.replace(store, _cold={}, _meta={})
        return store

    def _residency_entries(self) -> List[Tuple[str, Any]]:
        """``(algo_state key, store)`` of every table of per-client rows:
        the algorithm's own, then the error-feedback rows.  The staged
        tokens below follow this order."""
        out = []
        key = self._STORE_KEYS.get(self.algorithm)
        if key is not None:
            out.append((key, self.state_store))
        if self._ef:
            out.append(("ef_residuals", self._ef_store))
        return out

    @property
    def residency_stores(self) -> List[Any]:
        """Every store instance holding per-client rows (the engine's
        timing sums their transfer and spill counters)."""
        return [s for _, s in self._residency_entries()]

    def prepare_chunk_state(self, algo_state: Dict, ids_block) -> Dict:
        return self.commit_chunk_state(algo_state,
                                       self.stage_chunk_state(ids_block))

    def stage_chunk_state(self, ids_block) -> Any:
        toks = [(key, store.stage_chunk(ids_block))
                for key, store in self._residency_entries()
                if getattr(store, "needs_host_ids", False)]
        return toks or None

    def commit_chunk_state(self, algo_state: Dict, staged: Any) -> Dict:
        if staged is None:
            return algo_state
        stores = dict(self._residency_entries())
        out = dict(algo_state)
        for key, tok in staged:
            out[key] = stores[key].commit_chunk(out[key], tok)
        return out

    def init_state(self, task: Task, params: Pytree, n_clients: int) -> Dict:
        """The per-client state rows, in the engine's working
        representation (``params`` are its placed trees or flat
        buffers): scaffold's zero control variates (``c_global`` and
        ``c_clients``), moon's previous local models (``w_prev``, all
        the start params).  Error-feedback residuals (compressed
        uploads) are f32 rows in the flat bucket layout on both paths:
        the padded carry buffers on the fused path, the logical buckets
        on tree."""
        fops = self.flat_ops(task, self._device(params))
        store = self.state_store
        state: Dict[str, Pytree] = {}
        if self.algorithm == "scaffold":
            zeros = fops.zeros() if fops is not None else tm.zeros_like(params)
            state = {"c_global": zeros,
                     "c_clients": self._init_rows(store, zeros, n_clients,
                                                  fops)}
        elif self.algorithm == "moon":
            state = {"w_prev": self._init_rows(store, params, n_clients,
                                               fops)}
        if self._ef:
            tmpl = (fops.zeros(torch.float32) if fops is not None else
                    FlatView.of(param_shapes(task)).zeros(
                        torch.float32, self._device(params)))
            state["ef_residuals"] = self._init_rows(self._ef_store, tmpl,
                                                    n_clients, fops)
        return state

    def _init_rows(self, store, template: Pytree, n_clients: int,
                   fops: Optional[FlatParamOps]) -> Any:
        """``store``'s rows of ``template`` for ``n_clients`` clients (the
        pod's stores also read how ``fops`` lays the rows out)."""
        return store.init(template, n_clients)

    @staticmethod
    def _device(params: Pytree) -> torch.device:
        return tm.tree_leaves(params)[0].device

    def make_server_update(self, task: Task, device: torch.device
                           ) -> Optional[Tuple[Callable, Callable]]:
        """Server-side optimizer on the pseudo-gradient g = w − w_avg.
        Returns (init_fn, update_fn), or None for "none" (w ← w_avg).

        Tree path: the optax-style ``repro_torch.optim`` pair over trees.
        Fused path: the whole OptState is flat (moment buffers mirror the
        param buffers) and the update is one ``server_update`` kernel
        per bucket, in place on the old params and the moments, in its
        aggregate form: it reads the round's aggregate and forms
        ``avg − p`` itself."""
        if self.server_opt == "none":
            return None
        from repro_torch.optim.optimizers import (AdamWState, OptState,
                                                  adamw, sgd)

        if self.spec.update_impl == "tree":
            if self.server_opt == "momentum":
                opt = sgd(self.server_lr, momentum=self.server_momentum)
            else:
                opt = adamw(self.server_lr, b1=SERVER_ADAM_B1,
                            b2=SERVER_ADAM_B2)

            def update_tree(params, avg_params, state):
                return opt.apply(tm.sub(params, avg_params), state, params)

            return opt.init, update_tree

        fops = self.flat_ops(task, device)
        server_opt, lr, beta = (self.server_opt, self.server_lr,
                                self.server_momentum)
        with_moments = server_opt == "adam" or beta != 0.0
        # made once per phase: the rounds only read it on the device
        lr_t = torch.full((1,), lr, dtype=torch.float32, device=device)

        def init(p_bufs):
            if not with_moments:
                inner = ()
            elif server_opt == "momentum":
                inner = fops.zeros()
            else:
                inner = AdamWState(mu=fops.zeros(), nu=fops.zeros())
            return OptState(step=torch.zeros((), dtype=torch.int32,
                                             device=device), inner=inner)

        def update(p_bufs, avg_bufs, state):
            step = state.step + 1
            if not with_moments:
                new_p = fops.apply_delta(
                    p_bufs, {k: lr * (avg_bufs[k].float() - p.float())
                             for k, p in p_bufs.items()})
                return new_p, OptState(step=step, inner=())
            # the kernel forms avg − p itself (the aggregate form)
            if server_opt == "momentum":
                new_p, (m,) = fops.server_update(
                    p_bufs, None, (state.inner,), lr_t, avg_bufs=avg_bufs,
                    opt="momentum", beta=beta)
                return new_p, OptState(step=step, inner=m)
            t = step.to(torch.float32)
            scalars = torch.cat([lr_t,
                                 (1.0 - torch.pow(SERVER_ADAM_B1, t)).reshape(1),
                                 (1.0 - torch.pow(SERVER_ADAM_B2, t)).reshape(1)])
            new_p, (mu, nu) = fops.server_update(
                p_bufs, None, (state.inner.mu, state.inner.nu), scalars,
                avg_bufs=avg_bufs, opt="adam", b1=SERVER_ADAM_B1,
                b2=SERVER_ADAM_B2)
            return new_p, OptState(step=step, inner=AdamWState(mu=mu, nu=nu))

        return init, update

    def _aggregate(self, task: Task, device: torch.device,
                   fops: Optional[FlatParamOps]) -> Callable:
        """``aggregate(inputs, params, stacked, algo_state) ->
        (new_params, algo_state)`` for the spec: compressed uploads
        (with the EF rows gathered and scattered), DP / secure agg, or
        plain FedAvg — on trees (``fops`` None) or flat buffers."""
        spec = self.spec
        comp = spec.compression
        ef, store = self._ef, self._ef_store

        def to_device(tree):
            return tm.tree_map(lambda x: torch.as_tensor(x).to(
                device=device, dtype=torch.float32), tree)

        if compression.compression_on(comp):
            view = FlatView.of(param_shapes(task))

            def aggregate(inputs, params, stacked, state):
                res = (store.gather(state["ef_residuals"], inputs.ids)
                       if ef else None)
                if fops is None:
                    new_p, new_r = compression.tree_compressed_aggregate(
                        comp, view, params, stacked, inputs.weights, res)
                else:
                    new_p, new_r = compression.fused_compressed_aggregate(
                        comp, fops, params, stacked, inputs.weights, res)
                if ef:
                    state = dict(state, ef_residuals=store.scatter(
                        state["ef_residuals"], inputs.ids, new_r))
                return new_p, state
            return aggregate

        if privacy.privacy_on(spec.dp, spec.secure_agg):
            def aggregate(inputs, params, stacked, state):
                if fops is None:
                    normal_fn = inputs.normal_fn(
                        lambda key: privacy.tree_normal(key, params, device),
                        to_device)
                    return privacy.tree_dp_aggregate(
                        spec.dp, spec.secure_agg, inputs.id_list(), params,
                        stacked, inputs.weights, normal_fn), state
                normal_fn = inputs.normal_fn(
                    fops.normal,
                    lambda tree: fops.pad(fops.flatten(to_device(tree))))
                return privacy.fused_dp_aggregate(
                    spec.dp, spec.secure_agg, fops, inputs.id_list(), params,
                    stacked, inputs.weights, normal_fn), state
            return aggregate

        if fops is None:
            return lambda inputs, params, stacked, state: (
                tm.stacked_weighted_mean(stacked, inputs.weights), state)
        return lambda inputs, params, stacked, state: (
            fused_aggregate(fops, params, stacked, inputs.weights), state)

    def client_state(self, fops: Optional[FlatParamOps], params: Pytree,
                     ids: torch.Tensor, lr_scale, algo_state: Dict,
                     frozen: Optional[Dict] = None
                     ) -> Tuple[Callable[[int], Dict], Callable]:
        """One round of the algorithm's per-client state, in the engine's
        representation (trees, or flat buffers when ``fops`` is given).
        Returns ``(extras_of, update)``: ``extras_of(slot)`` is the local
        fn's ``extras`` for client ``slot``; ``update(ends)`` takes the
        stacked ``(K, ...)`` client end states and returns the new
        ``algo_state``.

          fedprox  : anchor on the round's start params.
          scaffold : (option II) ``c − c_i`` once per round as a (K, ...)
                     stack, client k's correction its row k;
                     ``c_i⁺ = c_i − c + (w − w_i)/(S·lr·lr_scale)``, then
                     ``c ← c + (K/N)·mean(c_i⁺ − c_i)`` and the rows
                     scattered back.
          moon     : the clients' previous local models gathered; their
                     end states scattered back."""
        algo, spec, store = self.algorithm, self.spec, self.state_store
        unpack = ((lambda b: fops.unflatten(b, frozen)) if fops is not None
                  else (lambda t: t))

        def row(tree, slot):
            return tm.tree_map(lambda t: t[slot], tree)

        if algo == "fedavg":
            return (lambda slot: {}), (lambda ends: algo_state)
        if algo == "fedprox":
            anchor = {"w_global": dict(zip(tm.tree_paths(params),
                                           tm.tree_leaves(params)))
                      if fops is None else fops.prox_anchor(params)}
            return (lambda slot: anchor), (lambda ends: algo_state)
        if algo == "scaffold":
            c, c_all = algo_state["c_global"], algo_state["c_clients"]
            c_i = store.gather(c_all, ids)
            c_diff = tm.tree_map(lambda g, l: g[None] - l, c, c_i)
            key = "c_diff" if fops is None else "c_diff_flat"

            def update(ends):
                denom = spec.n_steps * spec.lr * lr_scale
                c_i_new = tm.tree_map(
                    lambda ci, cg, p, wl:
                    ci - cg[None] + (p[None] - wl) / denom,
                    c_i, c, params, ends)
                frac = ids.shape[0] / store.population(c_all)
                c_new = tm.tree_map(
                    lambda cg, new, old: cg + frac * torch.mean(new - old,
                                                                dim=0),
                    c, c_i_new, c_i)
                return dict(algo_state, c_global=c_new,
                            c_clients=store.scatter(c_all, ids, c_i_new))
            return (lambda slot: {key: row(c_diff, slot)}), update
        w_prev_all = algo_state["w_prev"]                # moon
        w_prev = store.gather(w_prev_all, ids)
        anchor = unpack(params)

        def moon_extras(slot):
            return {"w_global": anchor, "w_prev": unpack(row(w_prev, slot))}
        return moon_extras, lambda ends: dict(
            algo_state, w_prev=store.scatter(w_prev_all, ids, ends))

    def build_round(self, task: Task, device: torch.device) -> Callable:
        fops = self.flat_ops(task, device)
        local = make_local_fn(
            self.task_over_batch(task, self.spec.batch_size), self.spec,
            fops, self.grad_reducer(fops))
        aggregate = self._aggregate(task, device, fops)

        def body(params, inputs: RoundInputs, lr_scale, algo_state):
            K = inputs.ids.shape[0]
            extras_of, update = self.client_state(fops, params, inputs.ids,
                                                  lr_scale, algo_state,
                                                  inputs.frozen)
            losses = []
            if fops is None:
                ends = []
                for slot in range(K):
                    w_end, loss = local(params, inputs.sampler(slot),
                                        lr_scale, extras_of(slot))
                    ends.append(w_end)
                    losses.append(loss)
                stacked = tm.tree_map(lambda *xs: torch.stack(xs), *ends)
            else:
                stacked = fops.stacked_empty(K)
                for slot in range(K):
                    row = {k: b[slot] for k, b in stacked.items()}
                    for k, r in row.items():
                        r.copy_(params[k])
                    _, loss = local(row, inputs.sampler(slot), lr_scale,
                                    extras_of(slot), inputs.frozen)
                    losses.append(loss)
            algo_state = update(stacked)
            new_params, algo_state = aggregate(inputs, params, stacked,
                                               algo_state)
            if inputs.on_aggregate is not None:
                inputs.on_aggregate(inputs, params, stacked, new_params)
            return new_params, algo_state, torch.stack(losses).mean()

        return body

    def record(self, ledger, k: int, params: Pytree, task: Task) -> None:
        comp = self.spec.compression
        filt = effective_trainable_filter(self.spec)
        # the upload departs from the full model X whenever the wire
        # carries less: compressed deltas, a trainable slice, or both
        payload = (_upload_payload_bytes(task, comp, filt)
                   if compression.compression_on(comp) or filt is not None
                   else None)
        ledger.record_round(self.algorithm, k, params,
                            secure_agg=self.spec.secure_agg,
                            x_bytes=_logical_model_bytes(task),
                            payload_bytes=payload)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def make_eval_fn(task: Task, batch: int, device: Device = None) -> Callable:
    """Host-side evaluation on ``device`` (default CUDA), one call per
    test batch: ``evaluate(params, test_x, test_y) -> float``, the
    batches' accuracies averaged with their sizes as weights.  The
    parity oracle of the engine's eval stream, and a way to evaluate a
    model outside an engine run."""
    dev = resolve_device(device)

    @torch.no_grad()
    def evaluate(params, test_x, test_y) -> float:
        test_x, test_y = np.asarray(test_x), np.asarray(test_y)
        accs, ws = [], []
        for s in range(0, len(test_y), batch):
            bx = torch.as_tensor(test_x[s:s + batch]).to(dev)
            by = torch.as_tensor(test_y[s:s + batch]).to(device=dev,
                                                        dtype=torch.int64)
            accs.append(float(task.accuracy(params, bx, by)))
            ws.append(len(by))
        return float(np.average(accs, weights=ws))

    return evaluate


@functools.lru_cache(maxsize=64)
def make_accuracy_metric(task: Task) -> Callable:
    """Default eval metric: per-sample accuracy,
    ``metric(params, bx, by) -> (B,)``."""

    def metric(params, bx, by):
        correct = (task.predict_fn(params, bx) == by).to(torch.float32)
        return correct.reshape(correct.shape[0], -1).mean(dim=1)

    return metric


def batch_test_set(test_x, test_y, batch: int) -> Tuple:
    """Batch the held-out test set for the eval stream.

    Returns host arrays ``(ev_x, ev_y, ev_w)``: ``(n_batches, B, ...)``
    data (tail batch padded by wrapping around to the front of the test
    set) and ``(n_batches, B)`` float32 weights — 1 for real samples, 0
    for pad — so the weighted mean over the stream is exact."""
    test_x, test_y = np.asarray(test_x), np.asarray(test_y)
    n = len(test_y)
    B = max(1, min(batch, n))
    n_batches = -(-n // B)
    pad = n_batches * B - n
    idx = np.concatenate([np.arange(n), np.arange(pad) % n])
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    shape = (n_batches, B)
    return (test_x[idx].reshape(shape + test_x.shape[1:]),
            test_y[idx].reshape(shape + test_y.shape[1:]),
            w.reshape(shape))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """Host-side schedule knobs shared by every strategy (see the module
    docstring for ``sampling`` and ``batch_indices``).  ``eval_every``
    ≤ 0 disables evaluation; otherwise the engine evaluates every
    ``eval_every`` rounds and on the final round.

    ``overlap=True`` pipelines the chunk loop: once chunk N's ops are
    enqueued, the engine plans chunk N+1 (its ids, the sparse stores'
    residency) and stages its refill rows with non-blocking copies, then
    reads chunk N's losses.  Only host work moves; the device ops and the
    random streams are those of the synchronous loop, so the two are
    bitwise equal.  A switch policy forces the synchronous loop."""
    rounds: int
    lr_decay: float = 0.998
    eval_every: int = 10
    eval_batch: int = 256
    seed: int = 0
    chunk_size: int = 1
    sampling: str = "device"        # device | host
    host_rng_offset: int = 0
    overlap: bool = False
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None
    # (round, client_slot, step) -> keep-mask: replaces the step's
    # generator as the loss's dropout source
    step_masks: Optional[Callable[[int, int, int], torch.Tensor]] = None
    # (round, kind, a, b) -> f32 param-shaped tree: replaces the keyed
    # privacy draws (kind "dp", a = client id; kind "mask", a < b)
    noise_draws: Optional[Callable[[int, str, int, Optional[int]],
                                   Pytree]] = None
    # (round, inputs, params, stacked, new_params) -> None: sees each
    # aggregate's inputs and buffers (chip_smoke.py rebuilds a private
    # round's uploads from them)
    on_aggregate: Optional[Callable[..., None]] = None

    def __post_init__(self):
        if self.sampling not in ("device", "host"):
            raise ValueError(f"unknown sampling mode {self.sampling!r}")


TIMING_KEYS = ("host_residency_ms", "staged_transfer_ms",
               "dispatch_enqueue_ms", "device_wait_ms",
               "spill_materialize_ms")


@dataclasses.dataclass
class FlatRows:
    """A flat-path run's params as buffers: this process's rows of the
    trainable buckets (``params``) and of the frozen ones (``frozen``;
    None without a trainable filter), as ``FlatParamOps.flatten`` and
    ``flatten_frozen`` pack them.  Given to :func:`run_rounds` as
    ``init_params``, the run places them as they are, and its result's
    ``params`` are the end rows (unpadded views), never gathered whole:
    a mesh rank of a model too large to hold whole on every rank starts
    and ends with its rows."""
    params: Dict[str, torch.Tensor]
    frozen: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class EngineResult:
    params: Pytree
    history: List[Dict[str, float]]
    algo_state: Dict[str, Pytree]
    server_state: Any = None
    dispatches: int = 0             # chunk-function calls this run
    # wall ms of the chunk loop, totals over the run (``TIMING_KEYS``):
    # host_residency_ms = stage planning + enqueueing its copies,
    # staged_transfer_ms = the copies' part of it (store-reported),
    # dispatch_enqueue_ms = commit + enqueueing the chunk's ops,
    # device_wait_ms = waiting on the chunk's one read,
    # spill_materialize_ms = the spill worker's ms (off the loop's path)
    timing: Optional[Dict[str, float]] = None
    # bytes of this process's carried buffers on the flat path: the
    # trainable "params" and the read-only "frozen" buckets (on a mesh,
    # the rank's rows); None on the tree path
    resident_bytes: Optional[Dict[str, int]] = None
    # whether the steps computed tensor-parallel over the mesh's model
    # axis (the pod's ShardedFlatOps.tp), or on whole leaves
    tp_compute: bool = False


@dataclasses.dataclass
class _ChunkPlan:
    """One dispatch's host-derived inputs, computable ahead of time so
    the overlapped loop can plan chunk N+1 while chunk N executes."""
    rnd: int
    R: int
    ids: torch.Tensor               # (R, K) on the device
    ids_np: np.ndarray              # the same on the host
    lr_scales: torch.Tensor
    ready: Any                      # event after the side stream's work
    do_eval: List[bool]
    staged: Any = None


def check_tensor_leaves(params: Pytree) -> None:
    """Raise ``TypeError`` for a param leaf that is not a tensor (as
    ResNet-8's int ``stride`` and string ``norm_kind``): the engines
    train tensor leaves only, as the JAX package's take arrays only."""
    for path, leaf in zip(tm.tree_paths(params), tm.tree_leaves(params)):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"param leaf {path!r} is a "
                            f"{type(leaf).__name__}, not a tensor: only "
                            f"tensor leaves train")


def run_rounds(task: Task, data: FederatedDataset, strategy,
               schedule: RoundSchedule, *,
               init_params: Optional[Pytree] = None,
               ledger=None, verbose: bool = False,
               eval_fn: Optional[Callable] = None,
               switch_policy=None,
               phase: str = "P2",
               label: Optional[str] = None,
               device: Device = None,
               history: bool = True) -> EngineResult:
    """Run ``schedule.rounds`` rounds of ``strategy`` on ``device``
    (default CUDA; raises without one unless ``device="cpu"``) and
    return the final params plus the per-round history.

    Evaluation runs on rounds where ``(round + 1) % eval_every == 0``
    and on the final round, over :func:`batch_test_set`'s weighted
    stream; ``eval_fn(params, bx, by) -> (B,)`` overrides the default
    accuracy metric.  ``init_params`` (a tree of tensors, or on the flat
    path a :class:`FlatRows`, which the result then gives back) is
    copied, so the caller's tensors are never modified.  The client ids
    of every chunk are known on the host before it runs (both sampling
    modes);
    a strategy whose stores need them (``SparseClientStateStore``)
    stages and commits residency before each chunk, and
    ``schedule.overlap`` stages chunk N+1 while chunk N runs.
    ``history=False`` never reads a value back to the host (a capture on
    fake tensors, ``repro_torch.launch.train.lower_pod_round``): the
    device work is the same, the history stays empty."""
    dev = resolve_device(device)
    if init_params is None:
        init_params = task.init(seeded_generator(schedule.seed))
    rows_in = isinstance(init_params, FlatRows)
    if not rows_in:
        check_tensor_leaves(init_params)
    fops = strategy.flat_ops(task, dev)
    if rows_in and fops is None:
        raise ValueError("FlatRows start the flat path only")
    # a trainable filter's frozen buckets: placed once, read only, never
    # padded or handed to a kernel, merged at the loss and the eval
    frozen = None
    if fops is None:
        params = strategy.place_params(init_params, dev)
    elif rows_in:
        params = fops.place(init_params.params)
        if fops.view.frozen_sizes:
            frozen = fops.place_frozen(init_params.frozen)
    else:
        params = fops.place(fops.flatten(init_params))
        if fops.view.frozen_sizes:
            frozen = fops.place_frozen(fops.flatten_frozen(init_params))

    n_clients = data.n_clients
    K = strategy.n_selected(n_clients)
    algo_state = strategy.init_state(task, params, n_clients)
    server = strategy.make_server_update(task, dev)
    server_state = server[0](params) if server is not None else ()
    server_state = strategy.place_server_state(server_state, task)
    body = strategy.build_round(task, dev)

    x_all, y_all, n_real = strategy.prepare_data(data, dev)
    n_per = data.n_per_client
    x_rows = x_all.reshape((n_clients * n_per,) + tuple(x_all.shape[2:]))
    y_rows = y_all.reshape((n_clients * n_per,) + tuple(y_all.shape[2:]))
    B = strategy.spec.batch_size
    # every process draws the whole batch and computes its part of it
    part = strategy.batch_shard(B)
    gen = seeded_generator(schedule.seed, dev)
    # re-seeded every step: the step's dropout source
    step_gen = seeded_generator(0, dev)

    with_eval = schedule.eval_every > 0 and len(np.asarray(data.test_y)) > 0
    metric = ev = None
    if with_eval:
        batched = batch_test_set(data.test_x, data.test_y, schedule.eval_batch)
        ev_batch = batched[0].shape[1]
        metric = eval_fn if eval_fn is not None else make_accuracy_metric(
            strategy.task_over_batch(task, ev_batch))
        ev = strategy.prepare_eval_data(batched, dev)

    host_rng = ids_gen = None
    if schedule.sampling == "host":
        host_rng = np.random.default_rng(schedule.seed +
                                         schedule.host_rng_offset)
    else:
        # re-seeded every round: the round's client ids
        ids_gen = seeded_generator(0, dev)
    # a chunk's ids and lr scales reach the device on a side stream, so
    # planning never waits on a chunk in flight
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    label = label or getattr(strategy, "name", phase)
    chunk = 1 if switch_policy is not None else max(1, schedule.chunk_size)
    # the pipeline plans chunk N+1 while chunk N runs; a switch policy
    # decides per round, so it forces the synchronous loop
    overlap = schedule.overlap and switch_policy is None
    stores = getattr(strategy, "residency_stores", [])
    residency = bool(algo_state) and any(
        getattr(s, "needs_host_ids", False) for s in stores)
    timing = dict.fromkeys(TIMING_KEYS, 0.0)

    def stores_ms(attr: str) -> float:
        return sum(float(getattr(s, attr, 0.0)) for s in stores)

    transfer_ms0 = stores_ms("staged_transfer_ms")
    spill_ms0 = stores_ms("spill_materialize_ms")

    def sampler(rnd: int, ids_r: torch.Tensor) -> Callable[[int], Sample]:
        def for_slot(slot: int) -> Sample:
            base = ids_r[slot] * n_per

            def sample(step: int):
                if schedule.batch_indices is not None:
                    idx = schedule.batch_indices(rnd, slot, step).to(
                        device=dev, dtype=torch.int64)
                else:
                    idx = torch.randint(0, n_per, (B,), generator=gen,
                                        device=dev)
                if schedule.step_masks is not None:
                    rng = schedule.step_masks(rnd, slot, step).to(dev)
                else:
                    # a rank of the pod draws for its own part of the batch
                    step_gen.manual_seed(fold_in(
                        schedule.seed, _DROPOUT_TAG, rnd, slot, step,
                        0 if part is None else part.start))
                    rng = step_gen
                if part is not None:
                    idx = idx[part]
                    if schedule.step_masks is not None:
                        rng = rng[part]
                rows = base + idx
                return x_rows.index_select(0, rows), \
                    y_rows.index_select(0, rows), rng
            return sample
        return for_slot

    @torch.no_grad()
    def evaluate(p) -> torch.Tensor:
        tree = fops.unflatten(p, frozen) if fops is not None else p
        ev_x, ev_y, ev_w = ev
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for b in range(ev_x.shape[0]):
            tot = tot + torch.sum(metric(tree, ev_x[b], ev_y[b]) * ev_w[b])
        tw = strategy.reduce_over_batch(torch.stack([tot, torch.sum(ev_w)]),
                                        ev_batch, mean=False)
        return tw[0] / tw[1]

    def round_draws(r: int):
        if schedule.noise_draws is None:
            return None
        return lambda kind, a, b=None: schedule.noise_draws(r, kind, a, b)

    def upload(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return (t.pin_memory().to(dev, non_blocking=True) if side is not None
                else t.to(dev))

    def make_plan(rnd: int) -> _ChunkPlan:
        """Everything host-derived a dispatch needs: the round window,
        the client ids (on the device and the host), the lr scales and
        the eval flags — functions of the host rng stream and the global
        round index, so planning in execution order keeps every stream
        the same whether or not the loop overlaps.  Under
        ``sampling="device"`` round r's ids are a ``torch.randperm``
        prefix from a generator re-seeded with ``fold_in(seed, _IDS_TAG,
        r)``, drawn here on the side stream and read back into pinned
        memory behind an event: the host waits on those draws only."""
        R = min(chunk, schedule.rounds - rnd)
        lr = np.array([schedule.lr_decay ** (rnd + j) for j in range(R)],
                      np.float32)
        ready = None
        with _on_stream(side):
            if host_rng is not None:
                ids_np = np.stack([host_rng.choice(n_clients, size=K,
                                                   replace=False)
                                   for _ in range(R)]).astype(np.int64)
                ids = upload(ids_np)
            else:
                rows = []
                for j in range(R):
                    ids_gen.manual_seed(fold_in(schedule.seed, _IDS_TAG,
                                                rnd + j))
                    rows.append(torch.randperm(n_clients, generator=ids_gen,
                                               device=dev)[:K])
                ids = torch.stack(rows)
                ids_host = (torch.empty(ids.shape, dtype=ids.dtype,
                                        pin_memory=True)
                            .copy_(ids, non_blocking=True)
                            if side is not None else ids)
            lr_scales = upload(lr)
            if side is not None:
                ready = torch.cuda.Event()
                ready.record(side)
        if host_rng is None:
            if ready is not None:
                ready.synchronize()     # the side stream's draws only
            ids_np = ids_host.numpy().copy()
        do_eval = [with_eval and ((rnd + j + 1) % schedule.eval_every == 0
                                  or rnd + j + 1 == schedule.rounds)
                   for j in range(R)]
        return _ChunkPlan(rnd=rnd, R=R, ids=ids, ids_np=ids_np,
                          lr_scales=lr_scales, ready=ready, do_eval=do_eval)

    def stage(plan: _ChunkPlan) -> None:
        if not residency:
            return
        t0 = time.perf_counter()
        plan.staged = strategy.stage_chunk_state(plan.ids_np.reshape(-1))
        timing["host_residency_ms"] += (time.perf_counter() - t0) * 1e3

    def run_chunk(plan: _ChunkPlan, params, algo_state, server_state):
        """One dispatch: R rounds, every value left on the device."""
        if plan.ready is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_event(plan.ready)
            plan.ids.record_stream(main)
            plan.lr_scales.record_stream(main)
        losses, metrics = [], []
        for j in range(plan.R):
            rnd = plan.rnd + j
            ids_r = plan.ids[j]
            inputs = RoundInputs(
                ids=ids_r, weights=n_real[ids_r].to(torch.float32),
                sampler=sampler(rnd, ids_r),
                round_key=fold_in(schedule.seed, rnd),
                draws=round_draws(rnd),
                host_ids=[int(i) for i in plan.ids_np[j]],
                on_aggregate=None if schedule.on_aggregate is None else
                functools.partial(schedule.on_aggregate, rnd), frozen=frozen)
            new_params, algo_state, loss = body(params, inputs,
                                                plan.lr_scales[j], algo_state)
            if server is not None:
                new_params, server_state = server[1](params, new_params,
                                                     server_state)
            params = new_params
            losses.append(loss)
            metrics.append(evaluate(params) if plan.do_eval[j] else None)
        return params, algo_state, server_state, losses, metrics

    rows: List[Dict[str, float]] = []
    dispatches = 0
    plan = make_plan(0) if schedule.rounds > 0 else None
    staged_plan = None
    while plan is not None:
        if staged_plan is not plan:     # the synchronous loop, or chunk 0
            stage(plan)
        t0 = time.perf_counter()
        algo_state = strategy.commit_chunk_state(algo_state, plan.staged)
        params, algo_state, server_state, losses, metrics = run_chunk(
            plan, params, algo_state, server_state)
        losses = strategy.reduce_over_batch(torch.stack(losses), B,
                                            mean=True)
        dispatches += 1
        timing["dispatch_enqueue_ms"] += (time.perf_counter() - t0) * 1e3

        rnd, R = plan.rnd, plan.R
        nxt = None
        if overlap and rnd + R < schedule.rounds:
            # the pipeline: plan and stage chunk N+1 while chunk N runs
            nxt = staged_plan = make_plan(rnd + R)
            stage(nxt)

        if history:
            t0 = time.perf_counter()
            losses = losses.cpu().numpy()             # one read per chunk
            timing["device_wait_ms"] += (time.perf_counter() - t0) * 1e3
            for j in range(R):
                if ledger is not None:
                    strategy.record(ledger, K, params, task)
                row = {"round": rnd + j, "local_loss": float(losses[j]),
                       "phase": phase}
                if plan.do_eval[j]:
                    row["acc"] = float(metrics[j])
                    if verbose:
                        print(f"[{label}] round {rnd + j + 1}/"
                              f"{schedule.rounds} loss="
                              f"{row['local_loss']:.4f} "
                              f"acc={row['acc']:.4f}", flush=True)
                rows.append(row)

            if switch_policy is not None and switch_policy.should_switch(
                    rnd + R - 1, rows):
                break
        if not overlap:
            nxt = make_plan(rnd + R) if rnd + R < schedule.rounds else None
        plan = nxt

    if residency:
        # the one spill worker runs in order: this joins every spill of
        # the run, so the timing holds all of them
        _spill_pool().submit(lambda: None).result()
    timing["staged_transfer_ms"] = stores_ms("staged_transfer_ms") - \
        transfer_ms0
    timing["spill_materialize_ms"] = stores_ms("spill_materialize_ms") - \
        spill_ms0
    resident = None
    if fops is not None:                # EngineResult speaks trees
        resident = {key: sum(b.numel() * b.element_size()
                             for b in (bufs or {}).values())
                    for key, bufs in (("params", params), ("frozen", frozen))}
        params = FlatRows({name: b[..., :fops.view.buffer_sizes[name]]
                           for name, b in params.items()}, frozen) \
            if rows_in else fops.unflatten(params, frozen)
        server_state = unpack_server_state(fops, server_state)
    return EngineResult(params=params, history=rows,
                        algo_state=algo_state, server_state=server_state,
                        dispatches=dispatches, timing=timing,
                        resident_bytes=resident,
                        tp_compute=getattr(fops, "tp", None) is not None)
