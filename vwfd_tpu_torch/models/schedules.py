"""Learning-rate schedules (port of vwfd_tpu/models/schedules.py:13-73).

Reference: models/lr_scheduler.py (``MultiStepLR_Restart``,
``CosineAnnealingLR_Restart``) and BaseModel's linear warmup
(models/base_model.py:51-75). Each schedule maps the optimizer's step count,
a 0-dim tensor on the device, to the learning rate as a float32 tensor, so
that a train step reads it without a host sync.
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["multistep_restart", "cosine_restart", "with_warmup"]


def _count(step, values):
    """Σ_v [step ≥ v] as a tensor on step's device."""
    v = torch.as_tensor(list(values), device=step.device)
    return (step >= v).sum()


def multistep_restart(base_lr: float, milestones: Sequence[int],
                      gamma: float = 0.5,
                      restarts: Optional[Sequence[int]] = None,
                      restart_weights: Optional[Sequence[float]] = None):
    """Decay ×gamma at each milestone; restarts reset the decay and scale
    the base LR by their weight (lr_scheduler.py:8-31)."""
    restarts = list(restarts or [])
    weights = list(restart_weights or [1.0] * len(restarts))
    milestones = list(milestones)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        if restarts:
            seg = _count(step, restarts)
            weight = torch.tensor([1.0] + weights, device=dev)[seg]
            local = step - torch.tensor([0] + restarts, device=dev)[seg]
        else:
            weight, local = torch.tensor(1.0, device=dev), step
        n = _count(local, milestones) if milestones else \
            torch.zeros((), dtype=torch.long, device=dev)
        return base_lr * weight * torch.pow(
            torch.tensor(gamma, device=dev), n.float())

    return schedule


def cosine_restart(base_lr: float, periods: Sequence[int],
                   eta_min: float = 0.0,
                   restart_weights: Optional[Sequence[float]] = None):
    """Cosine annealing with warm restarts (lr_scheduler.py:34-76)."""
    weights = list(restart_weights or [1.0] * len(periods))
    bounds = np.cumsum([0] + list(periods))

    def schedule(step: torch.Tensor) -> torch.Tensor:
        dev = step.device
        seg = torch.clamp(_count(step, bounds[1:].tolist()), 0,
                          len(periods) - 1)
        start = torch.tensor(bounds[:-1].tolist(), device=dev)[seg]
        period = torch.tensor(list(periods), device=dev)[seg]
        w = torch.tensor(weights, device=dev)[seg]
        t = (step - start).float() / period.float()
        return eta_min + 0.5 * (base_lr * w - eta_min) * (
            1 + torch.cos(math.pi * t))

    return schedule


def with_warmup(schedule_or_lr, warmup_steps: int):
    """Linear warmup over ``warmup_steps`` (base_model.py:61-75)."""
    if warmup_steps <= 0:
        return schedule_or_lr

    def base(step):
        if callable(schedule_or_lr):
            return schedule_or_lr(step)
        return torch.tensor(schedule_or_lr, device=step.device)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.float() / warmup_steps, 0.0, 1.0)
        return base(step) * frac

    return schedule
