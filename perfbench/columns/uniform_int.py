"""Integers uniform on ``[low, high]`` (both ends included), int32."""
from __future__ import annotations

import torch


def make(spec: dict, rows: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(int(spec["low"]), int(spec["high"]) + 1, (rows,),
                         generator=gen, device=device, dtype=torch.int32)
