"""The federated round engine — ONE driver for both CyclicFL phases.

The counterpart of ``repro/fl/engine.py`` on the host backend, with a
synchronous round loop.  A ``RoundStrategy`` decides what a round is:

  RelayStrategy     : P1 — the model hops client → client through the
                      selected clients in order, NO aggregation.
  AggregateStrategy : P2 — K independent local runs from the same start
                      (one after another, client k's end state written
                      into row k of a ``(K, N)`` stack), then the
                      weighted FedAvg mean and an optional server
                      optimizer (FedAvgM / FedAdam).

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
parity tests inject the JAX package's threefry draws through it).

Not ported yet: the fedprox/scaffold/moon algorithms and the per-client
state stores (ROADMAP.md item M4b), the sparse store and the
overlapped pipeline (M10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.federated import FederatedDataset
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
from repro_torch.utils.device import Device, resolve_device, seeded_generator

Pytree = Any

ALGORITHMS = ("fedavg", "fedprox", "scaffold", "moon")
SERVER_OPTS = ("none", "momentum", "adam")

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


class HostBackend:
    """Backend hooks of the single-device engine."""

    def flat_ops(self, task: Task, device: torch.device
                 ) -> Optional[FlatParamOps]:
        """The flat-buffer representation, or None on the tree path."""
        if self.spec.update_impl == "tree":
            return None
        return host_flat_ops(task, ops.fused_interpret(self.spec.update_impl),
                             torch.device(device))

    def n_selected(self, n_clients: int) -> int:
        return max(1, int(round(self.participation * n_clients)))


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

    def init_state(self, task: Task, params: Pytree, n_clients: int) -> Dict:
        return {}

    def make_server_update(self, task: Task, device: torch.device):
        return None

    def build_round(self, task: Task, device: torch.device) -> Callable:
        local = make_local_fn(task, self.spec, self.flat_ops(task, device))

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
    state_store: Any = None         # per-client state stores: M4b, M10

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.algorithm != "fedavg":
            not_ported(f"algorithm={self.algorithm!r}", "M4b")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(f"unknown server_opt {self.server_opt!r}")
        if self.state_store is not None:
            not_ported("state_store (dense M4b, sparse M10)", "M10")

    @property
    def name(self) -> str:
        return self.algorithm

    def init_state(self, task: Task, params: Pytree, n_clients: int) -> Dict:
        return {}

    def make_server_update(self, task: Task, device: torch.device
                           ) -> Optional[Tuple[Callable, Callable]]:
        """Server-side optimizer on the pseudo-gradient g = w − w_avg.
        Returns (init_fn, update_fn), or None for "none" (w ← w_avg).

        Tree path: the optax-style ``repro_torch.optim`` pair over trees.
        Fused path: the whole OptState is flat (moment buffers mirror the
        param buffers) and the update is one ``server_update`` kernel
        per bucket, in place on the old params and the moments."""
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
            delta = {k: avg_bufs[k].float() - p_bufs[k].float()
                     for k in p_bufs}
            step = state.step + 1
            if not with_moments:
                new_p = fops.apply_delta(
                    p_bufs, {k: lr * d for k, d in delta.items()})
                return new_p, OptState(step=step, inner=())
            if server_opt == "momentum":
                new_p, (m,) = fops.server_update(
                    p_bufs, delta, (state.inner,), lr_t, opt="momentum",
                    beta=beta)
                return new_p, OptState(step=step, inner=m)
            t = step.to(torch.float32)
            scalars = torch.cat([lr_t,
                                 (1.0 - torch.pow(SERVER_ADAM_B1, t)).reshape(1),
                                 (1.0 - torch.pow(SERVER_ADAM_B2, t)).reshape(1)])
            new_p, (mu, nu) = fops.server_update(
                p_bufs, delta, (state.inner.mu, state.inner.nu), scalars,
                opt="adam", b1=SERVER_ADAM_B1, b2=SERVER_ADAM_B2)
            return new_p, OptState(step=step, inner=AdamWState(mu=mu, nu=nu))

        return init, update

    def build_round(self, task: Task, device: torch.device) -> Callable:
        fops = self.flat_ops(task, device)
        local = make_local_fn(task, self.spec, fops)

        if fops is None:
            def body(params, inputs: RoundInputs, lr_scale, algo_state):
                ends, losses = [], []
                for slot in range(inputs.ids.shape[0]):
                    w_end, loss = local(params, inputs.sampler(slot),
                                        lr_scale)
                    ends.append(w_end)
                    losses.append(loss)
                stacked = tm.tree_map(lambda *xs: torch.stack(xs), *ends)
                new_params = tm.stacked_weighted_mean(stacked,
                                                      inputs.weights)
                return new_params, algo_state, torch.stack(losses).mean()
            return body

        def body(params, inputs: RoundInputs, lr_scale, algo_state):
            K = inputs.ids.shape[0]
            stacked = fops.stacked_empty(K)
            losses = []
            for slot in range(K):
                row = {k: b[slot] for k, b in stacked.items()}
                for k, r in row.items():
                    r.copy_(params[k])
                _, loss = local(row, inputs.sampler(slot), lr_scale)
                losses.append(loss)
            new_params = fused_aggregate(fops, params, stacked,
                                         inputs.weights)
            return new_params, algo_state, torch.stack(losses).mean()

        return body

    def record(self, ledger, k: int, params: Pytree, task: Task) -> None:
        ledger.record_round(self.algorithm, k, params,
                            x_bytes=_logical_model_bytes(task))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

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
        params = tm.tree_map(lambda x: x.detach().to(dev, copy=True),
                             init_params)
    else:
        params = fops.place(fops.flatten(init_params))

    n_clients = data.n_clients
    K = strategy.n_selected(n_clients)
    algo_state = strategy.init_state(task, params, n_clients)
    server = strategy.make_server_update(task, dev)
    server_state = server[0](params) if server is not None else ()
    body = strategy.build_round(task, dev)

    x_all, y_all, n_real = data.device_arrays(dev)
    n_per = data.n_per_client
    x_rows = x_all.reshape((n_clients * n_per,) + tuple(x_all.shape[2:]))
    y_rows = y_all.reshape((n_clients * n_per,) + tuple(y_all.shape[2:]))
    B = strategy.spec.batch_size
    gen = seeded_generator(schedule.seed, dev)

    with_eval = schedule.eval_every > 0 and len(np.asarray(data.test_y)) > 0
    metric = ev = None
    if with_eval:
        metric = eval_fn if eval_fn is not None else make_accuracy_metric(task)
        ev_x, ev_y, ev_w = batch_test_set(data.test_x, data.test_y,
                                          schedule.eval_batch)
        ev = (torch.as_tensor(ev_x).to(dev),
              torch.as_tensor(ev_y).to(device=dev, dtype=torch.int64),
              torch.as_tensor(ev_w).to(dev))

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
                rows = base + idx
                return x_rows.index_select(0, rows), \
                    y_rows.index_select(0, rows)
            return sample
        return for_slot

    @torch.no_grad()
    def evaluate(p) -> torch.Tensor:
        tree = fops.unflatten(p) if fops is not None else p
        ev_x, ev_y, ev_w = ev
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for b in range(ev_x.shape[0]):
            tot = tot + torch.sum(metric(tree, ev_x[b], ev_y[b]) * ev_w[b])
        return tot / torch.sum(ev_w)

    def run_chunk(params, algo_state, server_state, rnd: int, R: int,
                  ids: Optional[torch.Tensor], lr_scales: torch.Tensor,
                  do_eval: List[bool]):
        """One dispatch: R rounds, every value left on the device."""
        losses, metrics = [], []
        for j in range(R):
            ids_r = (ids[j] if ids is not None else
                     torch.randperm(n_clients, generator=gen,
                                    device=dev)[:K])
            inputs = RoundInputs(ids=ids_r,
                                 weights=n_real[ids_r].to(torch.float32),
                                 sampler=sampler(rnd + j, ids_r))
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
        ids = None
        if host_rng is not None:
            ids = torch.as_tensor(np.stack([
                host_rng.choice(n_clients, size=K, replace=False)
                for _ in range(R)])).to(device=dev, dtype=torch.int64)
        lr_scales = torch.tensor(
            [schedule.lr_decay ** (rnd + j) for j in range(R)],
            dtype=torch.float32).to(dev)
        do_eval = [with_eval and ((rnd + j + 1) % schedule.eval_every == 0
                                  or rnd + j + 1 == schedule.rounds)
                   for j in range(R)]
        params, algo_state, server_state, losses, metrics = run_chunk(
            params, algo_state, server_state, rnd, R, ids, lr_scales,
            do_eval)
        dispatches += 1

        losses = torch.stack(losses).cpu().numpy()    # one read per chunk
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
