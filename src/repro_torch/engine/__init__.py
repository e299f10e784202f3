"""Morsel-driven engine: columns, morsels, the plan API and its executors.

Port of ``repro.engine``, exporting the same names:
``from repro_torch.engine import GroupByPlan, AggSpec, Table`` is the
front door.
"""
from repro_torch.engine.columns import Table, combine_keys
from repro_torch.engine.executors import make_executor, resolve_plan, resolve_plan_stats
from repro_torch.engine.groupby import (
    AggSpec,
    GroupByOperator,
    GroupByOverflowError,
    expand_agg_specs,
    groupby,
)
from repro_torch.engine.morsels import DEFAULT_MORSEL_ROWS, morselize_chunk
from repro_torch.engine.plan_api import (
    ExecutionPolicy,
    GroupByPlan,
    SaturationPolicy,
    StreamHandle,
    execute,
    iter_chunks,
)
from repro_torch.engine.plans import Aggregate, Filter, Scan
from repro_torch.engine.spill import SpillManager

__all__ = [
    "Table",
    "combine_keys",
    "AggSpec",
    "GroupByOperator",
    "GroupByOverflowError",
    "expand_agg_specs",
    "groupby",
    "DEFAULT_MORSEL_ROWS",
    "morselize_chunk",
    "Aggregate",
    "Filter",
    "Scan",
    "ExecutionPolicy",
    "GroupByPlan",
    "SaturationPolicy",
    "execute",
    "iter_chunks",
    "make_executor",
    "resolve_plan",
    "resolve_plan_stats",
    "SpillManager",
    "StreamHandle",
]
