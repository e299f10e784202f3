"""Partial-aggregate materialization (paper §3.2).

Only :func:`finalize` is ported so far: the fused route updates its
accumulators inside the kernel.  ``AggState`` and the update strategies
(scatter, onehot, sort_segment, serialized) come with the scan route.
"""
from __future__ import annotations

import torch


def finalize(kind: str, acc: torch.Tensor, count_acc: torch.Tensor | None = None):
    """Materialize final aggregate values: untouched min/max identities
    (±inf) become NaN, mean is sum / max(count, 1)."""
    if kind in ("min", "max"):
        return torch.where(torch.isinf(acc), torch.full_like(acc, float("nan")), acc)
    if kind == "mean":
        if count_acc is None:
            raise ValueError("mean needs its count accumulator")
        return acc / torch.clamp(count_acc, min=1.0)
    return acc
