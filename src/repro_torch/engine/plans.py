"""Tiny push-based query plans over the morsel engine.

Port of ``repro.engine.plans``: enough of a planner to express the paper's
workload (scan → [filter] → group-by aggregate).  ``Aggregate`` lowers to
the declarative :class:`GroupByPlan` and streams chunks through
``plan.collect``, so a strategy sweep over one query is a one-field change
(``strategy=``).  ``Scan`` is a :class:`ChunkSource` (it has
``chunks()``).  The executor runs on ``ExecutionPolicy.device`` (None →
``"cuda"``); pass ``execution=ExecutionPolicy(device="cpu")`` for the
kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Sequence

import torch

from repro_torch.engine.columns import Table
from repro_torch.engine.groupby import AggSpec
from repro_torch.engine.plan_api import ExecutionPolicy, GroupByPlan


@dataclass
class Scan:
    source: Table
    chunk_rows: int = 1 << 16

    def chunks(self):
        n = self.source.num_rows
        for start in range(0, n, self.chunk_rows):
            end = min(start + self.chunk_rows, n)
            yield Table({k: v[start:end] for k, v in self.source.columns.items()})


@dataclass
class Filter:
    predicate: Callable[[Table], torch.Tensor]  # rows -> bool mask

    def apply(self, chunk: Table) -> Table:
        # selection vectors, not compaction: the chunk keeps its shape and
        # the key canonicalization turns filtered-out keys into EMPTY
        out = dict(chunk.columns)
        out["__mask__"] = self.predicate(chunk)
        return Table(out)


@dataclass
class Aggregate:
    keys: Sequence[str]
    aggs: Sequence[AggSpec]
    max_groups: int | None = None
    update: str | None = None       # None → ExecutionPolicy / planner choice
    strategy: str = "concurrent"
    saturation: str | None = None   # None → grow if the bound is estimated, else raise
    execution: ExecutionPolicy | None = None

    def plan(self) -> GroupByPlan:
        execution = self.execution or ExecutionPolicy()
        if self.update is not None:
            execution = replace(execution, update=self.update)
        return GroupByPlan(
            keys=tuple(self.keys), aggs=tuple(self.aggs),
            strategy=self.strategy, max_groups=self.max_groups,
            saturation=self.saturation, execution=execution,
        )

    def run(self, plan_source: Scan, filt: Filter | None = None) -> Table:
        chunks = plan_source.chunks()
        if filt is not None:
            chunks = (filt.apply(c) for c in chunks)
        return self.plan().collect(chunks)
