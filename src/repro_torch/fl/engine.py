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
generator.  Batch indices come from a ``torch.Generator`` on the device
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
client id (``RoundInputs.round_key`` and the ids on the host: under
``sampling="device"`` that is one device→host read of the ids per
round), or come from ``schedule.noise_draws`` when it is set (the parity
tests inject the JAX package's threefry draws through it).
``schedule.on_aggregate`` sees each P2 aggregate's inputs, start
buffers, stacked client end states and new params (``chip_smoke.py``
rebuilds a private round's uploads from them).

Not ported yet: the sparse store and the overlapped pipeline (ROADMAP.md
item M10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import compression, privacy
from repro_torch.fl.local import (
    FlatParamOps,
    LocalSpec,
    Sample,
    host_flat_ops,
    make_local_fn,
    not_ported,
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
def _upload_payload_bytes(task: Task, comp) -> int:
    """Closed-form wire bytes of ONE client's upload over the task's
    logical flat bucket sizes (compressed when ``comp`` is lossy, else
    the dtype bytes of every bucket)."""
    view = FlatView.of(param_shapes(task))
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
    and the error-feedback residual rows of compressed uploads (the
    sparse store is ROADMAP.md item M10)."""

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


DENSE_STORE = DenseClientStateStore()


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
                             torch.device(device))

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

    def grad_reducer(self) -> Optional[Callable[[Pytree], Pytree]]:
        """The gradient hook between a step's backward and its step tail,
        on the tree and the fused path (None: the identity)."""
        return None

    def batch_shard(self, n: int) -> Optional[slice]:
        """The part of a batch of ``n`` that this process computes (None:
        all of it, and nothing to reduce)."""
        return None

    def reduce_over_batch(self, t: torch.Tensor, n: int, *,
                          mean: bool) -> torch.Tensor:
        """Combine per-process values of a batch of ``n`` (losses: mean;
        eval sums: sum) — the identity on one device."""
        return t


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

    def init_state(self, task: Task, params: Pytree, n_clients: int) -> Dict:
        return {}

    def make_server_update(self, task: Task, device: torch.device):
        return None

    def build_round(self, task: Task, device: torch.device) -> Callable:
        local = make_local_fn(task, self.spec, self.flat_ops(task, device),
                              self.grad_reducer())

        def body(params, inputs: RoundInputs, lr_scale, algo_state):
            losses = []
            for slot in range(inputs.ids.shape[0]):
                params, loss = local(params, inputs.sampler(slot), lr_scale)
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
    state_store: Any = DENSE_STORE  # the sparse store: M10

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(f"unknown server_opt {self.server_opt!r}")
        if not isinstance(self.state_store, DenseClientStateStore):
            not_ported("state_store other than dense", "M10")

    @property
    def name(self) -> str:
        return self.algorithm

    @property
    def _ef(self) -> bool:
        comp = self.spec.compression
        return compression.compression_on(comp) and comp.error_feedback

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
                     "c_clients": store.init(zeros, n_clients)}
        elif self.algorithm == "moon":
            state = {"w_prev": store.init(params, n_clients)}
        if self._ef:
            tmpl = (fops.zeros(torch.float32) if fops is not None else
                    FlatView.of(param_shapes(task)).zeros(
                        torch.float32, self._device(params)))
            state["ef_residuals"] = store.init(tmpl, n_clients)
        return state

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
        ef, store = self._ef, self.state_store

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
                     ids: torch.Tensor, lr_scale, algo_state: Dict
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
        unpack = fops.unflatten if fops is not None else (lambda t: t)

        def row(tree, slot):
            return tm.tree_map(lambda t: t[slot], tree)

        if algo == "fedavg":
            return (lambda slot: {}), (lambda ends: algo_state)
        if algo == "fedprox":
            anchor = {"w_global": unpack(params)}
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
        local = make_local_fn(task, self.spec, fops, self.grad_reducer())
        aggregate = self._aggregate(task, device, fops)

        def body(params, inputs: RoundInputs, lr_scale, algo_state):
            K = inputs.ids.shape[0]
            extras_of, update = self.client_state(fops, params, inputs.ids,
                                                  lr_scale, algo_state)
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
                                    extras_of(slot))
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
        payload = (_upload_payload_bytes(task, comp)
                   if compression.compression_on(comp) else None)
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
    ``eval_every`` rounds and on the final round."""
    rounds: int
    lr_decay: float = 0.998
    eval_every: int = 10
    eval_batch: int = 256
    seed: int = 0
    chunk_size: int = 1
    sampling: str = "device"        # device | host
    host_rng_offset: int = 0
    overlap: bool = False           # M10
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
        if self.overlap:
            not_ported("overlap=True", "M10")


@dataclasses.dataclass
class EngineResult:
    params: Pytree
    history: List[Dict[str, float]]
    algo_state: Dict[str, Pytree]
    server_state: Any = None
    dispatches: int = 0             # chunk-function calls this run


def run_rounds(task: Task, data: FederatedDataset, strategy,
               schedule: RoundSchedule, *,
               init_params: Optional[Pytree] = None,
               ledger=None, verbose: bool = False,
               eval_fn: Optional[Callable] = None,
               switch_policy=None,
               phase: str = "P2",
               label: Optional[str] = None,
               device: Device = None) -> EngineResult:
    """Run ``schedule.rounds`` rounds of ``strategy`` on ``device``
    (default CUDA; raises without one unless ``device="cpu"``) and
    return the final params plus the per-round history.

    Evaluation runs on rounds where ``(round + 1) % eval_every == 0``
    and on the final round, over :func:`batch_test_set`'s weighted
    stream; ``eval_fn(params, bx, by) -> (B,)`` overrides the default
    accuracy metric.  ``init_params`` (a tree of tensors) is copied, so
    the caller's tensors are never modified."""
    dev = resolve_device(device)
    if init_params is None:
        init_params = task.init(seeded_generator(schedule.seed))
    fops = strategy.flat_ops(task, dev)
    if fops is None:
        params = strategy.place_params(init_params, dev)
    else:
        params = fops.place(fops.flatten(init_params))

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
        metric = eval_fn if eval_fn is not None else make_accuracy_metric(task)
        batched = batch_test_set(data.test_x, data.test_y, schedule.eval_batch)
        ev_batch = batched[0].shape[1]
        ev = strategy.prepare_eval_data(batched, dev)

    host_rng = None
    if schedule.sampling == "host":
        host_rng = np.random.default_rng(schedule.seed +
                                         schedule.host_rng_offset)

    label = label or getattr(strategy, "name", phase)
    chunk = 1 if switch_policy is not None else max(1, schedule.chunk_size)

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
        tree = fops.unflatten(p) if fops is not None else p
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

    def run_chunk(params, algo_state, server_state, rnd: int, R: int,
                  ids: Optional[torch.Tensor], ids_np: Optional[np.ndarray],
                  lr_scales: torch.Tensor, do_eval: List[bool]):
        """One dispatch: R rounds, every value left on the device."""
        losses, metrics = [], []
        for j in range(R):
            ids_r = (ids[j] if ids is not None else
                     torch.randperm(n_clients, generator=gen,
                                    device=dev)[:K])
            inputs = RoundInputs(
                ids=ids_r, weights=n_real[ids_r].to(torch.float32),
                sampler=sampler(rnd + j, ids_r),
                round_key=fold_in(schedule.seed, rnd + j),
                draws=round_draws(rnd + j),
                host_ids=None if ids_np is None else
                [int(i) for i in ids_np[j]],
                on_aggregate=None if schedule.on_aggregate is None else
                functools.partial(schedule.on_aggregate, rnd + j))
            new_params, algo_state, loss = body(params, inputs, lr_scales[j],
                                                algo_state)
            if server is not None:
                new_params, server_state = server[1](params, new_params,
                                                     server_state)
            params = new_params
            losses.append(loss)
            metrics.append(evaluate(params) if do_eval[j] else None)
        return params, algo_state, server_state, losses, metrics

    history: List[Dict[str, float]] = []
    dispatches = 0
    rnd = 0
    while rnd < schedule.rounds:
        R = min(chunk, schedule.rounds - rnd)
        ids = ids_np = None
        if host_rng is not None:
            ids_np = np.stack([host_rng.choice(n_clients, size=K,
                                               replace=False)
                               for _ in range(R)])
            ids = torch.as_tensor(ids_np).to(device=dev, dtype=torch.int64)
        lr_scales = torch.tensor(
            [schedule.lr_decay ** (rnd + j) for j in range(R)],
            dtype=torch.float32).to(dev)
        do_eval = [with_eval and ((rnd + j + 1) % schedule.eval_every == 0
                                  or rnd + j + 1 == schedule.rounds)
                   for j in range(R)]
        params, algo_state, server_state, losses, metrics = run_chunk(
            params, algo_state, server_state, rnd, R, ids, ids_np,
            lr_scales, do_eval)
        dispatches += 1

        losses = strategy.reduce_over_batch(torch.stack(losses), B,
                                            mean=True)
        losses = losses.cpu().numpy()                 # one read per chunk
        for j in range(R):
            if ledger is not None:
                strategy.record(ledger, K, params, task)
            row = {"round": rnd + j, "local_loss": float(losses[j]),
                   "phase": phase}
            if do_eval[j]:
                row["acc"] = float(metrics[j])
                if verbose:
                    print(f"[{label}] round {rnd + j + 1}/{schedule.rounds} "
                          f"loss={row['local_loss']:.4f} acc={row['acc']:.4f}",
                          flush=True)
            history.append(row)

        rnd += R
        if switch_policy is not None and switch_policy.should_switch(
                rnd - 1, history):
            break

    if fops is not None:                # EngineResult speaks trees
        params = fops.unflatten(params)
        server_state = unpack_server_state(fops, server_state)
    return EngineResult(params=params, history=history,
                        algo_state=algo_state, server_state=server_state,
                        dispatches=dispatches)
