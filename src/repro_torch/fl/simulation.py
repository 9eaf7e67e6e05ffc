"""Federated-training simulation driver (P2) — a configuration shim over
the round engine (``repro_torch.fl.engine``, ``AggregateStrategy``).

The counterpart of ``repro/fl/simulation.py``.  FedAvg runs here, with
an optional server optimizer (FedAvgM / FedAdam).  The other algorithms
and the privacy, compression and PEFT options keep their config fields,
so a config written for the JAX package reads the same, but raise
``NotImplementedError`` naming the ROADMAP.md item that will bring them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.engine import (
    ALGORITHMS,
    AggregateStrategy,
    RoundSchedule,
    run_rounds,
)
from repro_torch.fl.local import LocalSpec, not_ported, validate_update_impl
from repro_torch.fl.task import Task
from repro_torch.utils.device import Device

Pytree = Any

__all__ = ["ALGORITHMS", "FLConfig", "ServerState", "FLResult",
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
    dp: Optional[Any] = None                # M8
    secure_agg: bool = False                # M8
    compression: Optional[Any] = None       # M9
    peft: Optional[str] = None              # M11
    trainable_filter: Optional[str] = None  # M11
    # (round, client_slot, step) -> LongTensor (B,): replaces the
    # engine's generator draws for the batch indices
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def __post_init__(self):
        validate_update_impl(self.update_impl)
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.algorithm != "fedavg":
            not_ported(f"algorithm={self.algorithm!r}", "M4b")
        if self.dp is not None or self.secure_agg:
            not_ported("dp/secure_agg", "M8")
        if self.compression is not None:
            not_ported("compression", "M9")
        if self.peft is not None or self.trainable_filter is not None:
            not_ported("peft/trainable_filter", "M11")

    def n_selected(self, n_clients: int) -> int:
        return max(1, int(round(self.participation * n_clients)))

    def local_spec(self) -> LocalSpec:
        return LocalSpec(
            n_steps=self.local_steps, batch_size=self.batch_size, lr=self.lr,
            momentum=self.momentum, weight_decay=self.weight_decay,
            variant=_VARIANTS[self.algorithm], grad_clip=self.grad_clip,
            update_impl=self.update_impl)

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


@dataclasses.dataclass
class FLResult:
    params: Pytree
    history: List[Dict[str, float]]
    state: ServerState
    dispatches: int = 0             # chunk-function calls (engine)

    def best(self, key: str = "acc") -> Dict[str, float]:
        rows = [h for h in self.history if key in h]
        return max(rows, key=lambda h: h[key]) if rows else {}


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
    state = ServerState(params=res.params, round=len(res.history))
    return FLResult(params=res.params, history=res.history, state=state,
                    dispatches=res.dispatches)
