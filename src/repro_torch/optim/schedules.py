"""LR schedules: pure functions of a 0-d int32 step tensor (port of
``repro.optim.schedules``).  The result is a 0-d float32 tensor on the
step's device, so the schedule never reads the step on the host."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    t = step.to(torch.float32)
    warm = peak_lr * t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)


def constant(step: torch.Tensor, *, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32, device=step.device)


__all__ = ["constant", "warmup_cosine"]
