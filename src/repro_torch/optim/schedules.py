"""Learning-rate schedules (pure functions of the step index), as fp32
scalar tensors: the port of the reference's ``optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    cd = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp_max(step / max(warmup_steps, 1), 1.0)
        return torch.where(step < warmup_steps, warm, cd(step - warmup_steps))

    return f
