"""Hand-written Hopper kernels and their wrappers.

ticket_hash — GET_OR_INSERT of a key column against a fresh table
  (``csrc/ticket_hash.cu``), the split route's first kernel.
segment_agg — fold of ticketed rows into a dense accumulator, scatter and
  onehot strategies (``csrc/segment_agg.cu``), the split route's second.
fused_groupby — ticketing + aggregation in one kernel against a table
  carried across chunks (``csrc/fused_groupby.cu``, ``kernel="fused"``),
  and ``scan_ticket``, the scan route's ticket stage (``kernel`` None /
  "off" / "scan_body"), a kernel of its own in the same source.
hybrid_registers — fold of a chunk's heavy-hitter rows into dense
  registers and the tail key column without them
  (``csrc/hybrid_registers.cu``, ``strategy="hybrid"``).
preagg — each worker's local pre-aggregation into a small direct-mapped
  table, spilling the rows that miss it (``csrc/preagg.cu``,
  ``strategy="partitioned"``).
grouped_matmul — the MoE layer's expert FFNs over expert-sorted rows
  (``csrc/grouped_matmul.cu``, kernel B3, in place of ``ragged_dot``).
segment_rows — whole float32 rows summed by ticket (``csrc/segment_rows.cu``,
  kernel B5, the ticketed embedding's backward in place of
  ``jax.ops.segment_sum``).
table_ops — GET_OR_INSERT into a carried table (``scan_ticket_kernel``
  unchecked), lookup and migrate (``csrc/table_ops.cu``): the merges, grows,
  lookups and migrations of the executors, in place of the reference's
  ``core.ticketing`` / ``core.resize`` while loops.

Each wrapper launches its kernel for CUDA tensors (built at first use by
``build``) and runs its plain PyTorch version for CPU tensors.
``ops.groupby_kernel`` is the one front door for direct kernel callers
(``fused=`` selects the route); the legacy direct entry points
(``groupby_pallas``, ``ticket``, ``segment_aggregate``) warn once per
process.  The fused module's one-shot ``fused_groupby`` function is
exported under the reference's name, ``fused_groupby_pallas`` (its own
name is the submodule's).  Nothing here builds or imports a compiler at
import time.
"""
from repro_torch.kernels.fused_groupby import (
    FusedState,
    fused_consume,
    fused_groupby_pallas,
    grow_fused_state,
    init_fused_state,
    merge_fused_state,
    scan_ticket,
    todo_from_start,
)
from repro_torch.kernels.ops import (
    groupby_kernel,
    groupby_pallas,
    multi_block_ticket,
    segment_aggregate,
    ticket,
)

__all__ = [
    "FusedState",
    "fused_consume",
    "fused_groupby_pallas",
    "groupby_kernel",
    "groupby_pallas",
    "grow_fused_state",
    "init_fused_state",
    "merge_fused_state",
    "multi_block_ticket",
    "scan_ticket",
    "segment_aggregate",
    "ticket",
    "todo_from_start",
]
