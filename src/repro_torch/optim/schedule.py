"""Learning-rate schedules: pure functions of a step tensor, in f32 (port
of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, base_lr: float, warmup: int, total: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_ratio * base_lr`` at ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def constant(step, *, base_lr: float) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step), base_lr,
                           dtype=torch.float32)
