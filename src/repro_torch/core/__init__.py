"""The paper's machinery in PyTorch: hashing, ticketing, resize, updates.

Port of ``repro.core``, exporting the same names.  The declarative front
door for running a GROUP BY is ``repro_torch.engine.GroupByPlan``; the
functions here are the stage machinery plus the legacy adapters that
lower to that plan API (``concurrent_groupby``, ``partitioned_groupby``,
``hybrid_groupby``).  Nothing here imports ``repro_torch.engine`` at
import time: the adapters import it when called.
"""
from repro_torch.core.aggregation import GroupByResult, concurrent_groupby, groupby_oracle
from repro_torch.core.adaptive import (
    Plan,
    RunningStats,
    WorkloadStats,
    choose_plan,
    sample_stats,
)
from repro_torch.core.hashing import EMPTY_KEY, table_capacity
from repro_torch.core.hybrid import detect_heavy_hitters, hybrid_groupby
from repro_torch.core.partitioned import partitioned_groupby
from repro_torch.core.resize import grow_bound, maybe_resize, migrate
from repro_torch.core.ticketing import (
    TicketTable,
    direct_ticketing,
    get_or_insert,
    lookup,
    make_table,
    sort_ticketing,
)
from repro_torch.core.updates import (
    UPDATE_FNS,
    AggState,
    finalize,
    get_update_fn,
    grow_agg_state,
    init_acc,
    init_agg_state,
    onehot_update,
    scatter_update,
    serialized_update,
    sort_segment_update,
    update_agg_state,
)

__all__ = [
    "GroupByResult",
    "concurrent_groupby",
    "groupby_oracle",
    "Plan",
    "RunningStats",
    "WorkloadStats",
    "choose_plan",
    "sample_stats",
    "EMPTY_KEY",
    "table_capacity",
    "detect_heavy_hitters",
    "hybrid_groupby",
    "partitioned_groupby",
    "TicketTable",
    "direct_ticketing",
    "get_or_insert",
    "lookup",
    "make_table",
    "sort_ticketing",
    "grow_bound",
    "maybe_resize",
    "migrate",
    "UPDATE_FNS",
    "AggState",
    "finalize",
    "get_update_fn",
    "grow_agg_state",
    "init_acc",
    "init_agg_state",
    "update_agg_state",
    "onehot_update",
    "scatter_update",
    "serialized_update",
    "sort_segment_update",
]
