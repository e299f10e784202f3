"""End-to-end fully concurrent group aggregation (paper §2.3, Fig. 2).

Port of ``repro.core.aggregation``.  :func:`concurrent_groupby` is a thin
adapter over the plan API (``GroupByPlan(strategy="concurrent",
raw_keys=True)``): one chunk through the scan route, the whole column as
one morsel unless ``morsel_size`` says otherwise.  :func:`groupby_oracle`
stays independent of that machinery (sort + segment reduce): it is the
reference the strategies are tested against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import to_i32_bits


class GroupByResult(NamedTuple):
    keys: torch.Tensor        # (max_groups,) int64 unsigned keys, EMPTY past num_groups
    values: torch.Tensor      # (max_groups,) or (max_groups, V) aggregates
    num_groups: torch.Tensor  # () int32


def concurrent_groupby(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    update: str = "scatter",
    max_groups: int,
    morsel_size: int | None = None,
    ticketing: str = "hash",
    capacity: int | None = None,
    saturation: str = "unchecked",
    device: str | None = None,
) -> GroupByResult:
    """GROUP BY keys AGGREGATE(kind) OVER values, fully concurrently.

    Args:
      keys: (N,) key column (uint32 values or their int32 bit patterns);
        EMPTY rows are ignored.
      values: (N,) value column, ignored for ``kind="count"``; an (N, V)
        block aggregates each trailing dim independently.
      kind: sum | count | min | max.
      update: scatter | onehot | sort_segment | serialized (§3.2).
      max_groups: the bound on unique keys.
      morsel_size: rows per morsel; None → one morsel (the whole column).
      ticketing: hash | sort (one-shot: the column is sorted as a whole) |
        direct (ticket == key over ``[0, max_groups)``).
      capacity: hash-table slots; default ``table_capacity``.
      saturation: unchecked (the legacy default: truncate past the bound)
        | raise | grow.
      device: where it runs; None → ``"cuda"``, ``"cpu"`` for the plain
        versions of the kernels.

    Returns a :class:`GroupByResult` with keys in ticket order.
    """
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
        execute,
    )

    keys = torch.as_tensor(keys)
    was_2d = values is not None and torch.as_tensor(values).dim() > 1
    table, vcols = arrays_as_table(keys, values)
    n = table.num_rows
    if kind == "count":
        aggs = [AggSpec("count")]
    else:
        aggs = [AggSpec(kind, c) for c in vcols]
    plan = GroupByPlan(
        keys=("__key__",), aggs=tuple(aggs), strategy="concurrent",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(
            update=update, morsel_rows=morsel_size or max(n, 1),
            capacity=capacity, ticketing=ticketing,
            key_domain=max_groups if ticketing == "direct" else None,
            device=device,
        ),
    )
    out = execute(plan, table)
    if kind != "count" and was_2d:
        acc = torch.stack([out[a.name] for a in aggs], dim=1)
    else:
        acc = out[aggs[0].name]
    return GroupByResult(out["key"], acc, out["__num_groups__"][0])


def groupby_oracle(keys, values=None, *, kind: str = "count", max_groups: int):
    """Sorted-group-by oracle used by tests, independent of the hash table
    and the executors: ``sort_ticketing`` + ``sort_segment_update``.
    Groups come in sorted-key order, not first-appearance order: compare
    as key → value maps."""
    keys = to_i32_bits(torch.as_tensor(keys)).reshape(-1)
    n = keys.shape[0]
    if values is None:
        values = torch.ones((n,), dtype=torch.float32, device=keys.device)
    values = torch.as_tensor(values).to(torch.float32)
    tickets, key_by_ticket, count = tk.sort_ticketing(keys)
    acc = up.init_acc(max_groups, kind, device=keys.device)
    acc = up.sort_segment_update(acc, tickets, values, kind=kind)
    kbt = key_by_ticket[:max_groups]
    if kbt.shape[0] < max_groups:
        kbt = torch.cat([kbt, kbt.new_full((max_groups - kbt.shape[0],), -1)])
    return GroupByResult(kbt.to(torch.int64) & 0xFFFFFFFF, up.finalize(kind, acc), count)
