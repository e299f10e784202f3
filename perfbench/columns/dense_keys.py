"""Keys of ``distinct`` dense ranks, ``[0, distinct)``, uniform over the rows:
``gen_keys``' "uniform" draw for the paper's cardinality classes, int32."""
from __future__ import annotations

import torch


def make(spec: dict, rows: int, gen: torch.Generator, device) -> torch.Tensor:
    distinct = int(spec["distinct"])
    if not 0 < distinct < 1 << 31:
        raise ValueError(f"distinct must lie in [1, 2^31), got {distinct}")
    return torch.randint(0, distinct, (rows,), generator=gen, device=device, dtype=torch.int32)
