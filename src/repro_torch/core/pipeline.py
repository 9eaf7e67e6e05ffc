"""Cyclic+Y — the end-to-end CyclicFL pipeline as a declarative phase
schedule.

The counterpart of ``repro/core/pipeline.py``: a phase is (config,
optional switch policy); ``run_phase_schedule`` threads the model and
one CommLedger through every phase, and ``run_cyclic_then_federated``
is the paper's two-phase pipeline (P1 cyclic relay → P2 FedAvg).  Both
run on ``device`` (default CUDA; ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.comm_accounting import CommLedger
from repro_torch.core.cyclic import CyclicConfig, CyclicResult, cyclic_pretrain
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.simulation import FLConfig, FLResult, run_federated
from repro_torch.fl.task import Task
from repro_torch.utils.device import Device

# config type -> (kind, runner); a runner has the driver signature
# runner(task, data, cfg, *, init_params, ledger, verbose, eval_fn,
# switch_policy, phase, device) and returns an object with ``.params``
# and ``.history``
_PHASE_RUNNERS: Dict[type, Tuple[str, Callable]] = {}


def register_phase_runner(cfg_type: type, kind: str,
                          runner: Callable) -> None:
    """Make ``Phase(cfg=<cfg_type instance>)`` runnable.  ``kind`` is
    "relay" (P1-style, no aggregation) or "aggregate"."""
    _PHASE_RUNNERS[cfg_type] = (kind, runner)


def _lookup_runner(cfg) -> Tuple[str, Callable]:
    for t in type(cfg).__mro__:
        if t in _PHASE_RUNNERS:
            return _PHASE_RUNNERS[t]
    raise TypeError(f"no phase runner registered for {type(cfg).__name__}; "
                    "see core.pipeline.register_phase_runner")


@dataclasses.dataclass(frozen=True)
class Phase:
    """One schedule entry: ``cfg`` picks the strategy through the runner
    registry, ``name`` tags the history rows, ``switch_policy`` may end
    the phase early, ``eval_fn`` overrides the eval metric."""
    name: str
    cfg: Any
    switch_policy: Optional[object] = None
    eval_fn: Optional[Callable] = None

    @property
    def kind(self) -> str:
        return _lookup_runner(self.cfg)[0]


@dataclasses.dataclass
class PhaseResult:
    phase: Phase
    result: Any                      # CyclicResult | FLResult

    @property
    def history(self) -> List[Dict[str, float]]:
        return self.result.history


@dataclasses.dataclass
class ScheduleResult:
    phases: List[PhaseResult]
    ledger: CommLedger

    @property
    def params(self):
        return self.phases[-1].result.params

    @property
    def history(self) -> List[Dict[str, float]]:
        """All phases' rows with a schedule-global round index."""
        hist: List[Dict[str, float]] = []
        for pr in self.phases:
            offset = len(hist)
            for h in pr.history:
                row = dict(h)
                row["round"] = offset + h["round"]
                hist.append(row)
        return hist

    def best_acc(self) -> Dict[str, float]:
        rows = [h for h in self.history if "acc" in h]
        return max(rows, key=lambda h: h["acc"]) if rows else {}


def run_phase_schedule(task: Task, data: FederatedDataset,
                       phases: Sequence[Phase],
                       verbose: bool = False,
                       ledger: Optional[CommLedger] = None,
                       device: Device = None) -> ScheduleResult:
    """Run ``phases`` in order on ``device``, each starting from the
    previous phase's final params, under one communication ledger."""
    ledger = ledger if ledger is not None else CommLedger()
    params = None
    results: List[PhaseResult] = []
    for ph in phases:
        _, runner = _lookup_runner(ph.cfg)
        res = runner(task, data, ph.cfg, init_params=params,
                     ledger=ledger, verbose=verbose, eval_fn=ph.eval_fn,
                     switch_policy=ph.switch_policy, phase=ph.name,
                     device=device)
        params = res.params
        results.append(PhaseResult(phase=ph, result=res))
    return ScheduleResult(phases=results, ledger=ledger)


register_phase_runner(CyclicConfig, "relay", cyclic_pretrain)
register_phase_runner(FLConfig, "aggregate", run_federated)


@dataclasses.dataclass
class PipelineResult:
    cyclic: Optional[CyclicResult]
    federated: FLResult
    ledger: CommLedger

    @property
    def history(self) -> List[Dict[str, float]]:
        hist = list(self.cyclic.history) if self.cyclic else []
        offset = len(hist)
        for h in self.federated.history:
            row = dict(h)
            row["round"] = offset + h["round"]
            hist.append(row)
        return hist

    def best_acc(self) -> Dict[str, float]:
        rows = [h for h in self.history if "acc" in h]
        return max(rows, key=lambda h: h["acc"]) if rows else {}

    def rounds_to_acc(self, target: float) -> Optional[int]:
        """First (global) round reaching ``target`` accuracy — the paper's
        convergence metric (Table III)."""
        for h in self.history:
            if h.get("acc", -1.0) >= target:
                return h["round"]
        return None


def run_cyclic_then_federated(
    task: Task,
    data: FederatedDataset,
    cyclic_cfg: Optional[CyclicConfig],
    fl_cfg: FLConfig,
    verbose: bool = False,
    switch_policy=None,
    device: Device = None,
) -> PipelineResult:
    """P1 then P2 on ``device`` (default CUDA); cyclic_cfg=None runs the
    w/o-Cyclic baseline under the same ledger."""
    phases: List[Phase] = []
    if cyclic_cfg is not None:
        phases.append(Phase("P1", cyclic_cfg, switch_policy=switch_policy))
    phases.append(Phase("P2", fl_cfg))
    sched = run_phase_schedule(task, data, phases, verbose=verbose,
                               device=device)
    cyc = sched.phases[0].result if cyclic_cfg is not None else None
    return PipelineResult(cyclic=cyc, federated=sched.phases[-1].result,
                          ledger=sched.ledger)
