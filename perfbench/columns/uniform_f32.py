"""float32 values uniform on ``[low, high)``."""
from __future__ import annotations

import torch


def make(spec: dict, rows: int, gen: torch.Generator, device) -> torch.Tensor:
    low, high = float(spec["low"]), float(spec["high"])
    v = torch.rand(rows, generator=gen, device=device, dtype=torch.float32)
    return v.mul_(high - low).add_(low)
