"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` x
    peak at ``total``: a float32 0-d tensor on the CPU, computed in float32
    with the reference's order of operations (Python constants rounded to
    float32 where they meet the step, as JAX's weak types round them)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(1, warmup), max=1.0)
    frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)
