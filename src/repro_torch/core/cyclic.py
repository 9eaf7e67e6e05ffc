"""CyclicFL — Algorithm 1: cyclic model pre-training (phase P1).

The counterpart of ``repro/core/cyclic.py``: the server relays ONE model
through a randomly-sampled group of clients *sequentially* each round,
with no aggregation, and returns the well-initialized global model.
This module is a configuration shim over the round engine
(``repro_torch.fl.engine``, ``RelayStrategy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.engine import RelayStrategy, RoundSchedule, run_rounds
from repro_torch.fl.local import LocalSpec, validate_update_impl
from repro_torch.fl.task import Task
from repro_torch.utils.device import Device

Pytree = Any

# P1 client ids come from np.random.default_rng(seed + 31) under
# sampling="host", as in the JAX package
HOST_RNG_OFFSET_P1 = 31


@dataclasses.dataclass(frozen=True)
class CyclicConfig:
    rounds: int = 100               # T_cyc
    participation: float = 0.25     # K_P1 / |S|  (paper default: 25%)
    local_steps: int = 20           # t_i — local update steps (paper: 20)
    batch_size: int = 32
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    lr_decay: float = 0.998
    grad_clip: Optional[float] = None
    eval_every: int = 10
    eval_batch: int = 256
    seed: int = 0
    chunk_size: int = 8             # rounds per chunk-function call
    sampling: str = "device"        # device | host
    update_impl: str = "tree"       # tree | fused | fused_interpret
    # (round, client_slot, step) -> LongTensor (B,): replaces the
    # engine's generator draws for the batch indices
    batch_indices: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def __post_init__(self):
        validate_update_impl(self.update_impl)

    def n_selected(self, n_clients: int) -> int:
        return max(1, int(round(self.participation * n_clients)))

    def local_spec(self) -> LocalSpec:
        return LocalSpec(
            n_steps=self.local_steps, batch_size=self.batch_size, lr=self.lr,
            momentum=self.momentum, weight_decay=self.weight_decay,
            variant="plain", grad_clip=self.grad_clip,
            update_impl=self.update_impl)

    def strategy(self) -> RelayStrategy:
        return RelayStrategy(spec=self.local_spec(),
                             participation=self.participation)

    def schedule(self) -> RoundSchedule:
        return RoundSchedule(
            rounds=self.rounds, lr_decay=self.lr_decay,
            eval_every=self.eval_every, eval_batch=self.eval_batch,
            seed=self.seed, chunk_size=self.chunk_size,
            sampling=self.sampling, host_rng_offset=HOST_RNG_OFFSET_P1,
            batch_indices=self.batch_indices)


@dataclasses.dataclass
class CyclicResult:
    params: Pytree
    history: List[Dict[str, float]]
    dispatches: int = 0             # chunk-function calls (engine)


def cyclic_pretrain(task: Task, data: FederatedDataset, cfg: CyclicConfig,
                    init_params: Optional[Pytree] = None,
                    ledger=None, verbose: bool = False,
                    eval_fn: Optional[Callable] = None,
                    switch_policy=None, phase: str = "P1",
                    device: Device = None) -> CyclicResult:
    """Run P1 on ``device`` (default CUDA) and return the
    well-initialized global model.  ``switch_policy`` (core.switch) may
    end P1 early based on the evaluation history."""
    res = run_rounds(task, data, cfg.strategy(), cfg.schedule(),
                     init_params=init_params, ledger=ledger, verbose=verbose,
                     eval_fn=eval_fn, switch_policy=switch_policy,
                     phase=phase, label="cyclic", device=device)
    return CyclicResult(params=res.params, history=res.history,
                        dispatches=res.dispatches)
