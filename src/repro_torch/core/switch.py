"""P1 → P2 switch policies (RQ3).

The paper shows (Fig 5/6) that final accuracy vs P1 duration is a
rise-then-slow-descent curve: too little cyclic training forfeits the
flat-basin benefit, too much wastes rounds that plain FL would use
better.  Policies below encode the practical answers:

  FixedRounds     — the paper's protocol (T_cyc = 100).
  AccuracyPlateau — switch when the P1 eval accuracy stops improving by
                    ``min_delta`` over a ``patience`` window; adaptive
                    version of the Fig-6 knee.
  BudgetFraction  — spend a fixed fraction of the total round budget in
                    P1 (the efficiency-first operating point).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Protocol


class SwitchPolicy(Protocol):
    def should_switch(self, rnd: int, history: List[Dict[str, float]]) -> bool:
        ...


@dataclasses.dataclass(frozen=True)
class FixedRounds:
    t_cyc: int = 100

    def should_switch(self, rnd: int, history) -> bool:
        return rnd + 1 >= self.t_cyc


@dataclasses.dataclass(frozen=True)
class AccuracyPlateau:
    """Switch once eval accuracy improves < ``min_delta`` for ``patience``
    consecutive evaluations (only rows containing 'acc' are counted)."""
    patience: int = 3
    min_delta: float = 0.002
    min_rounds: int = 10

    def should_switch(self, rnd: int, history) -> bool:
        if rnd + 1 < self.min_rounds:
            return False
        accs = [h["acc"] for h in history if "acc" in h]
        if len(accs) < self.patience + 1:
            return False
        recent = accs[-(self.patience + 1):]
        best_before = max(accs[:-self.patience])
        return all(a - best_before < self.min_delta for a in recent[1:])


@dataclasses.dataclass(frozen=True)
class BudgetFraction:
    total_rounds: int
    fraction: float = 0.1

    def should_switch(self, rnd: int, history) -> bool:
        return rnd + 1 >= max(1, int(self.total_rounds * self.fraction))
