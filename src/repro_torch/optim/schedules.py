"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
functions of the step (an int or a 0-dim tensor) to an f32 0-dim
tensor on the step's device, in the reference's f32 arithmetic."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def constant(v: float):
    return lambda step: torch.tensor(v, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0, 1)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def warmup_cosine(peak: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    cos = cosine_decay(peak, max(total_steps - warmup, 1), floor)

    def fn(step):
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return fn
