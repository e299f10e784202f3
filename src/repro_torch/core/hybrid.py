"""Hybrid aggregation — the paper's §6 future work (port of
``repro.core.hybrid``).

A sample names at most ``num_registers`` heavy-hitter candidate keys.  Rows
of a heavy key fold into per-key dense registers; the remaining tail rows
go through the concurrent pipeline, which the heavy-hitter removal has
stripped of its contention.  This addresses the paper's worst corner
(Table 2: unique keys under heavy hitters).

The execution lives in ``repro_torch.engine.executors._HybridExecutor``
behind ``GroupByPlan(strategy="hybrid")``; on a CUDA device the register
fold is the hand-written kernel ``kernels.hybrid_registers``.
:func:`hybrid_groupby` is the reference's signature-compatible adapter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.adaptive import sample_u32
from repro_torch.core.aggregation import GroupByResult
from repro_torch.core.hashing import EMPTY_KEY


def detect_heavy_hitters(keys: torch.Tensor, num_registers: int,
                         sample: int = 8192) -> np.ndarray:
    """Heavy-hitter candidates from a prefix sample, as the reference
    picks them: the ``num_registers`` most frequent keys of the first
    ``sample`` rows that hold more than 1% of the live sample, heaviest
    first (ties broken as the reference's ``argsort(counts)[::-1]`` over
    uint32-sorted keys).  A ``(num_registers,)`` uint32 array padded with
    ``EMPTY_KEY``."""
    _, flat = sample_u32(keys, sample)
    out = np.full((num_registers,), EMPTY_KEY, np.uint32)
    if flat.size == 0:
        return out
    uniq, counts = np.unique(flat, return_counts=True)
    order = np.argsort(counts)[::-1]
    top = [int(uniq[i]) for i in order[:num_registers] if counts[i] > flat.size * 0.01]
    out[: len(top)] = top
    return out


def hybrid_groupby(
    keys: torch.Tensor,
    values: torch.Tensor | None,
    heavy_keys,                # (R,) uint32 values (or int32 bit patterns), EMPTY-padded
    *,
    kind: str = "count",
    max_groups: int,
    capacity: int | None = None,
    saturation: str = "unchecked",
    device: str | None = None,
) -> GroupByResult:
    """Register + concurrent hybrid GROUP BY: an adapter over
    ``GroupByPlan(strategy="hybrid")`` with the heavy candidates pinned via
    ``ExecutionPolicy.heavy_keys``.  ``device``: None → ``"cuda"``."""
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
        as_group_result,
        execute,
    )

    table, _ = arrays_as_table(torch.as_tensor(keys), values)
    agg = AggSpec("count") if kind == "count" else AggSpec(kind, "v")
    plan = GroupByPlan(
        keys=("__key__",), aggs=(agg,), strategy="hybrid",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(capacity=capacity, heavy_keys=heavy_keys,
                                  device=device),
    )
    return as_group_result(execute(plan, table), agg)
