"""float64 values uniform on ``[low, high)``, rounded to ``decimals`` places
(H2O's ``round(runif(N, max=100), 6)``)."""
from __future__ import annotations

import torch


def make(spec: dict, rows: int, gen: torch.Generator, device) -> torch.Tensor:
    low, high = float(spec["low"]), float(spec["high"])
    v = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
    v = v.mul_(high - low).add_(low)
    return torch.round(v, decimals=int(spec["decimals"]))
