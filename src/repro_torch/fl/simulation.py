"""Federated-training simulation driver (P2) — a configuration shim over
the round engine (``repro_torch.fl.engine``, ``AggregateStrategy``).

The counterpart of ``repro/fl/simulation.py``.  FedAvg, FedProx,
SCAFFOLD and MOON run here, each with an optional server optimizer
(FedAvgM / FedAdam), DP-FedAvg and secure aggregation (``dp``,
``secure_agg``), compressed uploads (``compression``) and a trainable
slice (``peft`` / ``trainable_filter``, fused paths only).

``make_round_fn``, ``make_server_update`` and ``init_server_state`` are
the reference's single-round surfaces: plain functions over the
strategy's round body and server optimizer, with trees at the boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.engine import (
    ALGORITHMS,
    AggregateStrategy,
    RoundInputs,
    RoundKey,
    RoundSchedule,
    keyed_sampler,
    run_rounds,
)
from repro_torch.fl.compression import CompressionSpec, validate_compression
from repro_torch.fl.local import (LocalSpec, validate_peft,
                                  validate_update_impl)
from repro_torch.fl.privacy import DPSpec
from repro_torch.fl.task import Task
from repro_torch.utils.device import (Device, resolve_device,
                                      seeded_generator)

Pytree = Any

__all__ = ["ALGORITHMS", "FLConfig", "ServerState", "FLResult",
           "make_round_fn", "make_server_update", "init_server_state",
           "run_federated", "HOST_RNG_OFFSET_P2"]

# P2 client ids come from np.random.default_rng(seed + 17) under
# sampling="host", as in the JAX package
HOST_RNG_OFFSET_P2 = 17

_VARIANTS = {"fedavg": "plain", "fedprox": "fedprox", "scaffold": "scaffold",
             "moon": "moon"}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    algorithm: str = "fedavg"
    rounds: int = 100
    participation: float = 0.1      # fraction of clients per round (K_P2)
    local_steps: int = 25           # SGD steps per client per round
    batch_size: int = 32
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    lr_decay: float = 0.998         # per-round multiplicative decay (paper)
    mu: float = 0.01                # fedprox / moon coefficient
    temperature: float = 0.5        # moon
    grad_clip: Optional[float] = None
    server_opt: str = "none"        # none | momentum | adam
    server_lr: float = 1.0
    server_momentum: float = 0.9
    eval_every: int = 10
    eval_batch: int = 256
    seed: int = 0
    chunk_size: int = 8             # rounds per chunk-function call
    sampling: str = "device"        # device | host
    update_impl: str = "tree"       # tree | fused | fused_interpret
    dp: Optional[DPSpec] = None
    secure_agg: bool = False
    compression: Optional[CompressionSpec] = None
    peft: Optional[str] = None              # "lora:<r>"
    trainable_filter: Optional[str] = None  # a TRAINABLE_FILTERS name / regex
    # (round, client_slot, step) -> LongTensor (B,): replaces the
    # engine's generator draws for the batch indices
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def __post_init__(self):
        validate_update_impl(self.update_impl)
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        validate_compression(self.compression, dp=self.dp,
                             secure_agg=self.secure_agg)
        validate_peft(self.peft, trainable_filter=self.trainable_filter,
                      update_impl=self.update_impl)

    def n_selected(self, n_clients: int) -> int:
        return max(1, int(round(self.participation * n_clients)))

    def local_spec(self) -> LocalSpec:
        return LocalSpec(
            n_steps=self.local_steps, batch_size=self.batch_size, lr=self.lr,
            momentum=self.momentum, weight_decay=self.weight_decay,
            variant=_VARIANTS[self.algorithm], mu=self.mu,
            temperature=self.temperature, grad_clip=self.grad_clip,
            update_impl=self.update_impl, dp=self.dp,
            secure_agg=self.secure_agg, compression=self.compression,
            peft=self.peft, trainable_filter=self.trainable_filter)

    def strategy(self) -> AggregateStrategy:
        return AggregateStrategy(
            spec=self.local_spec(), algorithm=self.algorithm,
            participation=self.participation, server_opt=self.server_opt,
            server_lr=self.server_lr, server_momentum=self.server_momentum)

    def schedule(self) -> RoundSchedule:
        return RoundSchedule(
            rounds=self.rounds, lr_decay=self.lr_decay,
            eval_every=self.eval_every, eval_batch=self.eval_batch,
            seed=self.seed, chunk_size=self.chunk_size,
            sampling=self.sampling, host_rng_offset=HOST_RNG_OFFSET_P2,
            batch_indices=self.batch_indices)


@dataclasses.dataclass
class ServerState:
    params: Pytree
    round: int = 0
    c_global: Optional[Pytree] = None      # scaffold
    c_clients: Optional[Pytree] = None     # scaffold, stacked (n_clients, ...)
    w_prev: Optional[Pytree] = None        # moon, stacked (n_clients, ...)


@dataclasses.dataclass
class FLResult:
    params: Pytree
    history: List[Dict[str, float]]
    state: ServerState
    dispatches: int = 0             # chunk-function calls (engine)

    def best(self, key: str = "acc") -> Dict[str, float]:
        rows = [h for h in self.history if key in h]
        return max(rows, key=lambda h: h[key]) if rows else {}


def make_round_fn(task: Task, cfg: FLConfig, device: Device = None
                  ) -> Callable:
    """The one-round update on ``device`` (default CUDA), a single-round
    surface over ``AggregateStrategy``'s round body (the loop lives in
    ``repro_torch.fl.engine``)::

        round_fn(key, params, x_all, y_all, ids, weights, lr_scale,
                 algo_state, *, step_masks=None)
            -> (params, algo_state, metrics)

    ``key`` stands where the reference's PRNG key does (see
    ``engine.keyed_sampler``): an int also keys the round's privacy
    draws, and ``step_masks(client_slot, step)``, when given, is each
    step's dropout keep-mask in place of the keyed draw.
    ``x_all``/``y_all`` are ``(n_clients, n_per, ...)``; ``ids`` and
    ``weights`` the round's ``(K,)`` client ids and their sample counts; ``algo_state`` comes
    from :func:`init_server_state` and is updated in place.  The params
    are TREES on both paths: the fused path packs and unpacks them at
    the boundary.  The caller's params are never written."""
    dev = resolve_device(device)
    strategy = cfg.strategy()
    body = strategy.build_round(task, dev)
    fops = strategy.flat_ops(task, dev)
    B = cfg.batch_size

    def round_fn(key: RoundKey, params, x_all, y_all, ids, weights,
                 lr_scale, algo_state, *, step_masks=None):
        ids = torch.as_tensor(ids).to(device=dev, dtype=torch.int64)
        p = (fops.place(fops.flatten(params)) if fops is not None else
             strategy.place_params(params, dev))
        frozen = (fops.place_frozen(fops.flatten_frozen(params))
                  if fops is not None and fops.view.frozen_sizes else None)
        inputs = RoundInputs(
            ids=ids, weights=torch.as_tensor(weights).to(
                device=dev, dtype=torch.float32),
            sampler=keyed_sampler(key, x_all, y_all, ids, B, dev,
                                  step_masks),
            round_key=0 if callable(key) else int(key), frozen=frozen)
        p, algo_state, loss = body(p, inputs, torch.as_tensor(
            lr_scale, dtype=torch.float32).to(dev), algo_state)
        if fops is not None:
            p = fops.unflatten(p, frozen)
        return p, algo_state, {"local_loss": loss}

    return round_fn


def make_server_update(cfg: FLConfig, task: Task, device: Device = None):
    """The server optimizer step of ``AggregateStrategy.
    make_server_update`` on ``device`` (default CUDA): ``(init_fn,
    update_fn)``, or None for ``server_opt="none"``.  Both speak param
    TREES on both paths (the fused path packs and unpacks at the
    boundary, its OptState moments stay flat):
    ``update_fn(params, avg_params, state) -> (params, state)``."""
    dev = resolve_device(device)
    strategy = cfg.strategy()
    server = strategy.make_server_update(task, dev)
    if server is None:
        return None
    fops = strategy.flat_ops(task, dev)
    if fops is None:
        return server

    def init(params):
        return server[0](fops.place(fops.flatten(params)))

    def update(params, avg_params, state):
        new_p, state = server[1](fops.place(fops.flatten(params)),
                                 fops.place(fops.flatten(avg_params)), state)
        return fops.unflatten(new_p, fops.flatten_frozen(params)), state

    return init, update


def init_server_state(task: Task, cfg: FLConfig, n_clients: int,
                      init_params: Optional[Pytree] = None,
                      key: Optional[int] = None,
                      device: Device = None) -> ServerState:
    """The server's start state on ``device`` (default CUDA): the params
    (``init_params``, or ``task.init`` seeded with ``key`` or
    ``cfg.seed``) and the algorithm's client state, in the
    representation :func:`make_round_fn` takes (flat buffers on the
    fused path, where the reference builds moon's ``w_prev`` from the
    param trees)."""
    dev = resolve_device(device)
    if init_params is None:
        init_params = task.init(seeded_generator(
            cfg.seed if key is None else key))
    strategy = cfg.strategy()
    fops = strategy.flat_ops(task, dev)
    placed = (fops.place(fops.flatten(init_params)) if fops is not None
              else strategy.place_params(init_params, dev))
    algo_state = strategy.init_state(task, placed, n_clients)
    return ServerState(params=init_params,
                       c_global=algo_state.get("c_global"),
                       c_clients=algo_state.get("c_clients"),
                       w_prev=algo_state.get("w_prev"))


def run_federated(task: Task, data: FederatedDataset, cfg: FLConfig,
                  init_params: Optional[Pytree] = None,
                  ledger=None, verbose: bool = False,
                  eval_fn: Optional[Callable] = None,
                  switch_policy=None, phase: str = "P2",
                  device: Device = None) -> FLResult:
    """The P2 driver on ``device`` (default CUDA).  ``init_params`` is
    where CyclicFL plugs in: pass the P1-pre-trained model to get
    "Cyclic+<algorithm>"."""
    res = run_rounds(task, data, cfg.strategy(), cfg.schedule(),
                     init_params=init_params, ledger=ledger, verbose=verbose,
                     eval_fn=eval_fn, switch_policy=switch_policy,
                     phase=phase, label=cfg.algorithm, device=device)
    state = ServerState(params=res.params, round=len(res.history),
                        c_global=res.algo_state.get("c_global"),
                        c_clients=res.algo_state.get("c_clients"),
                        w_prev=res.algo_state.get("w_prev"))
    return FLResult(params=res.params, history=res.history, state=state,
                    dispatches=res.dispatches)
