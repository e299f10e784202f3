"""Array front door onto the kernel routes (port of ``repro.kernels.ops``).

Only ``groupby_kernel(..., fused=True)`` is ported: it runs a raw-keys
``GroupByPlan`` with ``ExecutionPolicy.kernel="fused"``.  The split
ticket + segment-aggregate route waits for its kernels (ROADMAP 'Modules
to port' item 4b).
"""
from __future__ import annotations

import torch


def groupby_kernel(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    max_groups: int,
    capacity: int | None = None,
    morsel_size: int = 1024,
    saturation: str = "raise",
    fused: bool = True,
    programs: int = 1,
    device: str | None = None,
):
    """Single-aggregate kernel-backed GROUP BY over raw arrays through the
    executor seam.  Returns ``(key_by_ticket, acc, num_groups)`` with keys
    as int64 holding the unsigned value."""
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
        execute,
    )

    if not fused:
        raise NotImplementedError(
            "the split kernel route is not ported to repro_torch yet: "
            "ROADMAP.md 'Modules to port' item 4b"
        )
    table, _ = arrays_as_table(keys, values)
    agg = AggSpec("count") if kind == "count" else AggSpec(kind, "v")
    plan = GroupByPlan(
        keys=("__key__",), aggs=(agg,), strategy="concurrent",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(
            kernel="fused", kernel_programs=programs, capacity=capacity,
            morsel_size=morsel_size, device=device,
        ),
    )
    out = execute(plan, table)
    return out["key"], out[agg.name], out["__num_groups__"][0]
