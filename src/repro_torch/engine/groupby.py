"""GROUP BY specs and the uniform result layout.

Ported so far: :class:`AggSpec`, :class:`GroupByOverflowError`,
:func:`build_result_table` and :func:`expand_agg_specs`.  The scan-compiled
``GroupByOperator`` and its pause body come with the scan route.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32
from repro_torch.engine.columns import Table


class GroupByOverflowError(RuntimeError):
    """The stream held more distinct keys than ``max_groups``."""


@dataclass(frozen=True)
class AggSpec:
    kind: str        # sum | count | min | max | mean
    column: str | None = None  # None for count

    @property
    def name(self) -> str:
        return f"{self.kind}({self.column or '*'})"


def build_result_table(aggs, get_acc, key_by_ticket, count, max_groups) -> Table:
    """THE uniform GROUP BY result layout: keys in ticket order (int64
    holding the unsigned key), one materialized column per aggregate (mean
    composed from sum/count, min/max identities → NaN), and the broadcast
    int32 group count."""
    kbt = key_by_ticket.reshape(-1)
    n = kbt.shape[0]
    if n < max_groups:
        kbt = torch.cat([kbt, kbt.new_full((max_groups - n,), EMPTY_I32)])
    out = {"key": kbt[:max_groups].to(torch.int64) & 0xFFFFFFFF}
    for a in aggs:
        if a.kind == "mean":
            out[a.name] = up.finalize(
                "mean", get_acc(a.column, "sum"), get_acc(a.column, "count")
            )
        else:
            out[a.name] = up.finalize(a.kind, get_acc(a.column, a.kind))
    count = torch.as_tensor(count, dtype=torch.int32, device=kbt.device).reshape(())
    out["__num_groups__"] = count.expand(max_groups).clone()
    return Table(out)


def expand_agg_specs(aggs: Sequence[AggSpec]) -> tuple:
    """Deduplicated ``(column, kind)`` accumulator specs for a query's aggs
    (``mean`` decomposes into sum+count, composed back at materialization)."""
    specs = []
    for a in aggs:
        kinds = ("sum", "count") if a.kind == "mean" else (a.kind,)
        for k in kinds:
            specs.append((a.column, k))
    return tuple(dict.fromkeys(specs))
