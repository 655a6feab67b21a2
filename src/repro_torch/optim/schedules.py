"""Learning-rate schedules, ported from ``repro/optim/schedules.py``: each
returns ``fn(step)`` of a step-count tensor (the optimizers' int32
``step``), an fp32 tensor on its device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.float(), max=total_steps) / max(total_steps, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))
    return fn
