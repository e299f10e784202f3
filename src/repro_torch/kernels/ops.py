"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

Padding to morsel multiples uses the sentinels both kernels treat as
no-ops (``EMPTY_I32`` keys, ticket -1).  ``interpret`` is accepted
everywhere for signature parity with the reference and ignored: the device
of the tensors picks the Hopper kernel (CUDA) or its plain version (CPU).

``groupby_kernel`` is the one front door for direct kernel callers:
``fused=False`` (the default, as in the reference) runs the split ticket +
segment-aggregate route (``ExecutionPolicy.kernel="split"``), ``fused=True``
the fused kernel.  ``make_scan_update_fn`` adapts the segment kernel to
the scan route's update-fn signature (``kernel="scan_body"``: the
``GroupByOperator`` calls it once per accumulator plane and ticket
launch).  ``multi_block_ticket`` radix-splits a key stream over independent
tables; tickets get a per-block base, so the global ticket space has
bounded gaps.  The legacy direct entry points (``ticket``,
``segment_aggregate``, ``groupby_pallas``) warn once per process.

Tickets issued past ``max_groups`` have their ``key_by_ticket`` writes
dropped, so a returned ``count > max_groups`` means the materialization is
truncated — the caller checks it.
"""
from __future__ import annotations

import functools
import warnings

import torch

from repro_torch.core.hashing import EMPTY_I32, slot_hash, to_i32_bits
from repro_torch.kernels.segment_agg import segment_agg
from repro_torch.kernels.ticket_hash import ticket_hash

# Deprecation shims: the engine selects kernels through
# ``ExecutionPolicy.kernel``; the direct entry points keep working but warn
# ONCE per process (per alias).  ``reset_deprecation_warnings`` re-arms them.
_WARNED: set = set()


def _warn_once(name: str, message: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    _WARNED.clear()


def _pad_to(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return torch.cat([x, x.new_full((rem,), fill)])


def _ticket(keys: torch.Tensor, *, capacity: int, max_groups: int,
            morsel_size: int = 1024, interpret: bool | None = None):
    """Kernel-backed GET_OR_INSERT over a key column of any length — the
    engine-internal entry (no deprecation warning).  Returns ``(tickets,
    key_by_ticket, count)``; the caller checks ``count`` against
    ``max_groups``."""
    n = keys.shape[0]
    kp = _pad_to(to_i32_bits(torch.as_tensor(keys)), morsel_size, EMPTY_I32)
    tickets, _, _, kbt, count = ticket_hash(
        kp, capacity=capacity, max_groups=max_groups, morsel_size=morsel_size)
    return tickets[:n], kbt, count


def ticket(keys: torch.Tensor, *, capacity: int, max_groups: int,
           morsel_size: int = 1024, interpret: bool | None = None):
    """DEPRECATED direct kernel call — select kernels through
    ``ExecutionPolicy.kernel`` or :func:`groupby_kernel` instead."""
    _warn_once(
        "ticket",
        "kernels.ops.ticket is deprecated; select the kernel route via "
        "ExecutionPolicy.kernel ('split'/'fused') or groupby_kernel()",
    )
    return _ticket(keys, capacity=capacity, max_groups=max_groups,
                   morsel_size=morsel_size, interpret=interpret)


def _segment_aggregate(tickets: torch.Tensor, values: torch.Tensor, *,
                       num_groups: int, kind: str = "sum",
                       strategy: str = "scatter", morsel_size: int = 1024,
                       interpret: bool | None = None) -> torch.Tensor:
    """Kernel-backed fold of a ticketed column of any length into a fresh
    ``(num_groups,)`` accumulator (engine-internal entry)."""
    tp = _pad_to(torch.as_tensor(tickets).to(torch.int32), morsel_size, -1)
    vp = _pad_to(torch.as_tensor(values).to(torch.float32), morsel_size, 0.0)
    return segment_agg(tp, vp, num_groups=num_groups, kind=kind,
                       strategy=strategy, morsel_size=morsel_size)


def segment_aggregate(tickets: torch.Tensor, values: torch.Tensor, *,
                      num_groups: int, kind: str = "sum",
                      strategy: str = "scatter", morsel_size: int = 1024,
                      interpret: bool | None = None) -> torch.Tensor:
    """DEPRECATED direct kernel call — select kernels through
    ``ExecutionPolicy.kernel`` or :func:`groupby_kernel`."""
    _warn_once(
        "segment_aggregate",
        "kernels.ops.segment_aggregate is deprecated; select the kernel "
        "route via ExecutionPolicy.kernel ('split'/'fused') or "
        "groupby_kernel()",
    )
    return _segment_aggregate(tickets, values, num_groups=num_groups, kind=kind,
                              strategy=strategy, morsel_size=morsel_size,
                              interpret=interpret)


@functools.lru_cache(maxsize=None)
def make_scan_update_fn(*, strategy: str = "scatter", morsel_size: int = 1024,
                        interpret: bool | None = None):
    """Adapt the segment kernel to the update-fn signature
    ``(acc, tickets, values, kind=...) -> acc`` of ``core.updates``: the
    kernel folds every row (a morsel, or a whole chunk's ticket vector)
    straight into the carried float32 accumulator, IN PLACE, so a call
    costs its rows and not the G-wide partial plus merge of the
    reference's form.  Rows whose ticket is < 0 or >= G are parked.
    ``onehot`` takes at most ``segment_agg.MAX_ONEHOT_GROUPS`` groups and
    raises ``ValueError`` past them.  Memoized, so operators with the same
    arguments share one function object, as in the reference."""

    def update_fn(acc, tickets, values, kind: str = "sum"):
        n = tickets.reshape(-1).shape[0]
        if n == 0:
            return acc
        ms = min(morsel_size, n)
        tp = _pad_to(tickets.reshape(-1).to(torch.int32), ms, -1)
        vp = _pad_to(values.reshape(-1).to(torch.float32), ms, 0.0)
        return segment_agg(tp, vp, num_groups=acc.shape[0], kind=kind,
                           strategy=strategy, morsel_size=ms, out=acc)

    return update_fn


def groupby_kernel(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    max_groups: int,
    capacity: int | None = None,
    morsel_size: int = 1024,
    update_strategy: str = "scatter",
    interpret: bool | None = None,
    saturation: str = "raise",
    fused: bool = False,
    programs: int = 1,
    device: str | None = None,
):
    """THE kernel front door: a single-aggregate GROUP BY over raw arrays
    through the executor seam.  ``fused=False`` runs the split route,
    ``fused=True`` the fused kernel with ``programs`` local tables.
    Returns ``(key_by_ticket, acc, num_groups)`` with keys as int64 holding
    the unsigned value."""
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
        execute,
    )

    table, _ = arrays_as_table(keys, values)
    agg = AggSpec("count") if kind == "count" else AggSpec(kind, "v")
    plan = GroupByPlan(
        keys=("__key__",), aggs=(agg,), strategy="concurrent",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(
            kernel="fused" if fused else "split", kernel_programs=programs,
            capacity=capacity, morsel_size=morsel_size, update=update_strategy,
            interpret=interpret, device=device,
        ),
    )
    out = execute(plan, table)
    return out["key"], out[agg.name], out["__num_groups__"][0]


def groupby_pallas(
    keys: torch.Tensor,
    values: torch.Tensor | None = None,
    *,
    kind: str = "count",
    max_groups: int,
    capacity: int | None = None,
    morsel_size: int = 1024,
    update_strategy: str = "scatter",
    interpret: bool | None = None,
    raise_on_overflow: bool = True,
    saturation: str | None = None,
    device: str | None = None,
):
    """DEPRECATED legacy adapter for the split route: behaves exactly like
    ``groupby_kernel(..., fused=False)``.  ``raise_on_overflow`` maps to
    ``saturation="raise"`` (False → ``"unchecked"``)."""
    _warn_once(
        "groupby_pallas",
        "kernels.ops.groupby_pallas is deprecated; use groupby_kernel() or "
        "a GroupByPlan with ExecutionPolicy.kernel='split'",
    )
    if saturation is None:
        saturation = "raise" if raise_on_overflow else "unchecked"
    return groupby_kernel(
        keys, values, kind=kind, max_groups=max_groups, capacity=capacity,
        morsel_size=morsel_size, update_strategy=update_strategy,
        interpret=interpret, saturation=saturation, fused=False, device=device,
    )


def multi_block_ticket(keys: torch.Tensor, *, blocks: int, capacity_per_block: int,
                       max_groups_per_block: int, morsel_size: int = 1024,
                       interpret: bool | None = None):
    """Radix-split ticketing: the key stream is partitioned by a seeded
    hash (``slot_hash(seed=13)``) into ``blocks`` sub-streams, each
    ticketed against its own table; global ticket = block ·
    ``max_groups_per_block`` + local ticket.  Returns ``(tickets,
    key_by_ticket of all blocks concatenated, counts (blocks,))``."""
    if blocks < 1 or blocks & (blocks - 1):
        raise ValueError(f"blocks must be a power of 2, got {blocks}")
    kb = to_i32_bits(torch.as_tensor(keys))
    bid = slot_hash(kb, blocks, seed=13)
    out = torch.full(kb.shape, -1, dtype=torch.int32, device=kb.device)
    kbts, counts = [], []
    for b in range(blocks):
        sel = bid == b
        kblock = torch.where(sel, kb, torch.full_like(kb, EMPTY_I32))
        tb, kbt_b, cnt_b = _ticket(
            kblock, capacity=capacity_per_block,
            max_groups=max_groups_per_block, morsel_size=morsel_size,
        )
        out = torch.where(sel, tb + b * max_groups_per_block, out)
        kbts.append(kbt_b)
        counts.append(cnt_b)
    return out, torch.cat(kbts), torch.stack(counts)
