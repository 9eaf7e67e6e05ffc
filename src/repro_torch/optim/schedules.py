"""Learning-rate schedules.  The paper decays lr to 99.8% per round.

The counterpart of ``repro/optim/schedules.py``.  A schedule is a
function ``sched(step) -> lr``: ``step`` is an int or an integer
tensor, and ``lr`` an f32 tensor on the step's device (the CPU for an
int), so a schedule read inside a loop on the card never waits on the
host.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)


def exponential_decay(lr: float, decay_rate: float = 0.998,
                      steps_per_round: int = 1):
    """Paper schedule: lr *= decay_rate once per FL round."""

    def sched(step):
        step = _step(step)
        rounds = torch.div(step, steps_per_round,
                           rounding_mode="floor").to(torch.float32)
        return torch.full((), lr, dtype=torch.float32,
                          device=step.device) * decay_rate ** rounds

    return sched


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.0):
    def sched(step):
        t = torch.clamp(_step(step).to(torch.float32) / max(total_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return sched


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def sched(step):
        step = _step(step)
        warm = lr * step.to(torch.float32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return sched
