"""Partitioned aggregation baseline (paper §2.2, Fig. 1 — Leis et al.).

Port of ``repro.core.partitioned``.  Two stages: (1) *local
pre-aggregation* — each worker aggregates its morsels into a small
fixed-size table and spills the rows that miss it; (2) *partition-wise
aggregation* — the pre-aggregates and the spilled rows are exchanged by
key partition and finished per partition.  At high cardinality nearly
every row spills and is aggregated twice: the overhead that fully
concurrent aggregation removes (Fig. 6 / Table 2).

A "worker" is a row of a ``(W, R)`` layout of the chunk.  The
pre-aggregation is ``kernels.preagg.preagg``: the hand-written kernels
(many CTAs per worker, by the first-row rule) on CUDA tensors, its plain
version on CPU tensors.  The exchange is a concatenation (the final
phase is order-insensitive, so this single-device form behaves as the
reference's), and the partition-wise phase is sort ticketing
(``core.ticketing.sort_ticketing``) + ``core.updates.sort_segment_update``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.aggregation import GroupByResult
from repro_torch.core.hashing import EMPTY_I32, to_i32_bits


class PreAggState(NamedTuple):
    keys: torch.Tensor  # (C,) int32 key bit patterns, EMPTY_I32 where free
    vals: torch.Tensor  # (C,) float32 partial aggregates
    cnts: torch.Tensor  # (C,) float32 partial counts (for mean / count kinds)


def make_preagg(capacity: int, kind: str, device=None) -> PreAggState:
    return PreAggState(
        keys=torch.full((capacity,), EMPTY_I32, dtype=torch.int32, device=device),
        vals=up.init_acc(capacity, kind, device=device),
        cnts=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


def preagg_morsel(state: PreAggState, keys, values, kind: str):
    """Local pre-aggregation of one morsel into the fixed table (one worker
    of ``kernels.preagg.preagg_plain``'s step; ``state`` is not modified).
    Returns ``(state, spill_mask)``: rows with ``spill_mask`` True missed
    the table (slot taken by another key, or the install vote lost to
    another key) and are spilled downstream as raw rows."""
    from repro_torch.kernels.preagg import preagg_step

    c = state.keys.shape[0]
    k = to_i32_bits(torch.as_tensor(keys))
    v = torch.as_tensor(values).reshape(-1).to(torch.float32).to(k.device)
    tkeys = torch.cat([state.keys, state.keys.new_full((1,), EMPTY_I32)])
    tvals = torch.cat([state.vals, up.init_acc(1, kind, device=k.device)])
    tcnts = torch.cat([state.cnts, state.cnts.new_zeros(1)])
    spill = preagg_step(tkeys, tvals, tcnts, k[None], v[None], kind=kind, capacity=c)
    return PreAggState(tkeys[:c], tvals[:c], tcnts[:c]), spill[0]


def partitioned_groupby(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    max_groups: int,
    num_workers: int = 8,
    preagg_capacity: int = 1024,
    morsel_size: int | None = None,
    saturation: str = "unchecked",
    device: str | None = None,
) -> GroupByResult:
    """Leis-style partitioned aggregation with ``num_workers`` workers: an
    adapter over ``GroupByPlan(strategy="partitioned")`` (the executor
    ``engine.executors._PartitionedExecutor`` calls
    :func:`_partitioned_impl`).  ``saturation="raise"|"grow"`` checks or
    recovers the bound.  ``device``: None → ``"cuda"``."""
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
        keys=("__key__",), aggs=(agg,), strategy="partitioned",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(
            num_workers=num_workers, preagg_capacity=preagg_capacity,
            preagg_morsel=morsel_size, device=device,
        ),
    )
    return as_group_result(execute(plan, table), agg)


def _partitioned_impl(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    max_groups: int,
    num_workers: int = 8,
    preagg_capacity: int = 1024,
    morsel_size: int | None = None,
) -> GroupByResult:
    """The preagg → exchange → partition-wise pipeline over one chunk (the
    executor's backend; reach it through ``GroupByPlan(strategy=
    "partitioned")``).  ``keys`` (int32 bit patterns, or any integer key
    tensor) must hold a multiple of ``num_workers`` rows.  Returns the
    group keys in ticket order as int32 bit patterns (at most
    ``max_groups``: fewer when the exchange holds fewer rows), the
    ``(max_groups,)`` aggregate and the group count."""
    from repro_torch.kernels.preagg import preagg

    keys = to_i32_bits(torch.as_tensor(keys))
    n = keys.shape[0]
    if values is None:
        values = torch.ones((n,), dtype=torch.float32, device=keys.device)
    values = values.reshape(-1).to(torch.float32)
    if n % num_workers:
        raise ValueError(f"{n} rows: pad the input to a multiple of num_workers={num_workers}")
    tkeys, tvals, _, spill = preagg(keys.reshape(num_workers, -1),
                                    values.reshape(num_workers, -1), kind=kind,
                                    capacity=preagg_capacity, morsel=morsel_size)
    allk, allv = exchange(keys, values, tkeys, tvals, spill, kind)
    return partition_wise(allk, allv, kind, max_groups)


def exchange(keys, values, tkeys, tvals, spill, kind: str):
    """The exchange: the pre-agg entries (key, partial) and the spilled raw
    rows (key, value; the kind's neutral where a row did not spill), one
    key column and one value column.  (The reference's pre-agg counts ride
    along too, but no kind reads them.)"""
    sm = spill.reshape(-1)
    skeys = torch.where(sm, keys, EMPTY_I32)
    if kind == "count":
        svals = sm.to(torch.float32)
    else:
        svals = torch.where(sm, values, 0.0 if kind == "sum" else up.neutral(kind).item())
    return torch.cat([tkeys.reshape(-1), skeys]), torch.cat([tvals.reshape(-1), svals])


def partition_wise(allk, allv, kind: str, max_groups: int) -> GroupByResult:
    """The partition-wise final aggregation of the exchanged rows (sort =
    radix partition): sort ticketing, then a sort-segment fold (sum for
    sum and count partials, min / max as themselves)."""
    tickets, key_by_ticket, count = tk.sort_ticketing(allk)
    acc = up.init_acc(max_groups, kind, device=allk.device)
    acc = up.sort_segment_update(acc, tickets, allv,
                                 kind=kind if kind in ("min", "max") else "sum")
    return GroupByResult(key_by_ticket[:max_groups], up.finalize(kind, acc), count)
