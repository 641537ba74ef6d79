"""Learning-rate schedules, indexed by step (the port of
``repro.optim.schedule``).

Each schedule maps a step tensor to the learning rate as a float32 tensor
on the step's device, computed in float32 as the reference computes it (a
Python float would be float64 and move ``lr`` in its last bits).
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_schedule"]


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return sched


def linear_schedule(peak_lr: float, warmup: int, total: int):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, peak_lr * (1 - frac))
    return sched
