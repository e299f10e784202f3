"""The one front door for GROUP BY: a declarative plan → executor API.

Port of ``repro.engine.plan_api``.  A :class:`GroupByPlan` says WHAT to
aggregate; ``make_executor`` (engine/executors.py) lowers it to a
streaming executor (``open → consume* → finalize``), and
:class:`StreamHandle` pulls chunks from any :class:`ChunkSource`:

    plan = GroupByPlan(
        keys=["k"], aggs=[AggSpec("count"), AggSpec("mean", "v")],
        strategy="concurrent", max_groups=1 << 20,
        execution=ExecutionPolicy(kernel="fused"),   # device=None → "cuda"
    )
    handle = plan.stream(source)   # StreamHandle: nothing consumed yet
    handle.pump(8)                 # pull + aggregate 8 chunks
    partial = handle.snapshot()    # idempotent mid-stream materialize
    result = handle.result()       # drain the source, finalize

The port runs every plan of the reference: the default plan
(``strategy="auto"``, ``max_groups=None``, resolved from a sample of each
stream's first chunk), ``strategy="concurrent"`` with hash ticketing on
every kernel route (None / "off" / "scan_body": the scan route; "split";
"fused"), with sort or direct ticketing, ``strategy="hybrid"``,
``strategy="partitioned"``, ``saturation="spill"`` and
``strategy="sharded"`` over ``ExecutionPolicy.mesh`` (a
``repro_torch.parallel.sharding.Mesh``).  Stream checkpoints
(``StreamHandle.save`` / ``GroupByPlan.restore``, ``engine/elastic.py``)
cover every executor but the fused route's, in the reference's commit
format.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Iterator, Sequence

import torch

from repro_torch.core.hashing import to_i32_bits
from repro_torch.engine.columns import Table
from repro_torch.engine.groupby import AggSpec, GroupByOverflowError, expand_agg_specs
from repro_torch.engine.morsels import DEFAULT_MORSEL_ROWS
from repro_torch.obs import trace

STRATEGIES = ("auto", "concurrent", "partitioned", "hybrid", "pallas", "sharded")

# THE kernel selector (ExecutionPolicy.kernel), as in the reference:
# None | off | scan_body (the scan route) | split | fused.
KERNELS = (None, "off", "scan_body", "split", "fused")


class SaturationPolicy:
    """What to do when the stream holds more distinct keys than planned."""

    RAISE = "raise"          # refuse to materialize truncated results
    GROW = "grow"            # pause → grow → resume, then materialize
    UNCHECKED = "unchecked"  # paper's perfect-estimate regime: no check
    SPILL = "spill"          # out-of-core: max_groups is a device residency budget

    ALL = (RAISE, GROW, UNCHECKED, SPILL)


@dataclass(frozen=True)
class ExecutionPolicy:
    """How a plan runs: the reference's fields, plus ``device``.  Fields
    the port's routes do not read (``interpret``) are kept so that a plan
    reads the same in both packages."""

    pipeline: str = "scan"
    morsel_rows: int = DEFAULT_MORSEL_ROWS
    # observability: None → follow the global obs.metrics enable flag
    instrument: bool | None = None
    update: str | None = None
    load_factor: float = 0.5
    capacity: int | None = None       # probe-table slots; None → table_capacity
    kernel: str | None = None         # THE kernel selector (see KERNELS)
    kernel_programs: int = 1          # fused: per-program local tables
    use_kernel: bool = False          # deprecated alias for kernel="scan_body"
    ticketing: str = "hash"
    key_domain: int | None = None
    prefetch: int = 2                 # in-flight chunks before the oldest poll
    spill_partitions: int = 32
    morsel_size: int = 1024           # fused kernel morsel
    interpret: bool | None = None     # Pallas-only; ignored by the port
    num_workers: int = 8
    preagg_capacity: int = 1024
    preagg_morsel: int | None = None
    mesh: Any = None
    axis: str = "data"
    shard_merge: str = "dense_psum"
    max_local_groups: int | None = None
    partition_capacity: int | None = None
    num_registers: int = 8
    heavy_keys: Any = None
    # where the executor runs: None → "cuda"; only an explicit "cpu" runs
    # the plain PyTorch versions of the kernels
    device: str | None = None


@dataclass(frozen=True)
class GroupByPlan:
    """Declarative GROUP BY specification (see ``repro.engine.plan_api``).

    Attributes:
      keys: grouping key column names (hash-combined unless ``raw_keys``).
      aggs: list of :class:`AggSpec` (sum/count/min/max/mean over columns).
      strategy: ``auto`` or ``concurrent | partitioned | hybrid | pallas |
        sharded``.
      max_groups: cardinality bound; None → estimated from a sample.
      saturation: :class:`SaturationPolicy`; None → ``raise`` for an
        explicit bound, ``grow`` for an estimated one.
      execution: :class:`ExecutionPolicy`.
      raw_keys: the single key column already IS the uint32 key space.
    """

    keys: Sequence[str]
    aggs: Sequence[AggSpec]
    strategy: str = "auto"
    max_groups: int | None = None
    saturation: str | None = None
    execution: ExecutionPolicy = field(default_factory=ExecutionPolicy)
    raw_keys: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; available: {STRATEGIES}"
            )
        if self.saturation is not None and self.saturation not in SaturationPolicy.ALL:
            raise ValueError(
                f"unknown saturation policy {self.saturation!r}; "
                f"available: {SaturationPolicy.ALL}"
            )
        if self.execution.kernel not in KERNELS:
            raise ValueError(
                f"unknown kernel selector {self.execution.kernel!r}; "
                f"available: {KERNELS}"
            )
        if self.execution.kernel_programs < 1:
            raise ValueError("kernel_programs must be >= 1")
        if not self.aggs:
            raise ValueError("at least one AggSpec required")
        if not self.keys:
            raise ValueError("at least one key column required")

    def with_(self, **kw) -> "GroupByPlan":
        """Copy with fields replaced (sweep convenience)."""
        return replace(self, **kw)

    def run(self, table: Table) -> Table:
        return execute(self, table)

    def stream(self, source, *, prefetch: int | None = None) -> "StreamHandle":
        """Open a pull-based streaming aggregation over ``source``; nothing
        is consumed until the handle is pumped.  ``prefetch`` overrides
        ``execution.prefetch`` (0 = synchronous ingest)."""
        from repro_torch.engine.executors import make_executor

        ex = make_executor(self)
        ex.open()
        pf = self.execution.prefetch if prefetch is None else prefetch
        return StreamHandle(ex, iter_chunks(source), prefetch=pf)

    def collect(self, source) -> Table:
        """Stream ``source`` to exhaustion and return the final result."""
        return self.stream(source).result()

    def restore(self, path: str, source, *,
                prefetch: int | None = None) -> "StreamHandle":
        """Resume a stream from its newest :meth:`StreamHandle.save` commit
        under ``path`` (the JAX package's commits too): rebuild the
        executor state on this plan's device and fast-forward ``source``
        (replayed from its beginning — it must be re-iterable with a stable
        chunk order) past the chunks the checkpoint already aggregated.
        The restoring plan must ask the same query.  See
        ``engine/elastic.py``."""
        from repro_torch.engine.elastic import restore_stream

        return restore_stream(self, path, source, prefetch=prefetch)


def iter_chunks(source) -> Iterator[Table]:
    """Anything chunk-shaped → an iterator of ``Table``: one ``Table``, an
    object with ``chunks()``, or an iterable of tables."""
    if isinstance(source, Table):
        return iter((source,))
    if hasattr(source, "chunks"):
        return iter(source.chunks())
    if isinstance(source, (Iterator, Iterable)):
        return iter(source)
    raise TypeError(
        f"not a chunk source: {type(source).__name__} (expected a Table, an "
        "object with .chunks(), or an iterable of Tables)"
    )


class StreamHandle:
    """A streaming GROUP BY in flight: pull-based, double-buffered,
    snapshot-able (see ``repro.engine.plan_api.StreamHandle``).

    Each pulled chunk goes through the executor's ``consume_async``; the
    blocking ``poll`` of a chunk's control signals is deferred until
    ``prefetch`` newer chunks are dispatched, so the host stages chunk
    *k+1* while the device still runs chunk *k*."""

    def __init__(self, executor, chunks: Iterator[Table], prefetch: int = 2):
        self._ex = executor
        self._chunks = chunks
        self._prefetch = max(int(prefetch), 0)
        self._inflight: deque = deque()
        self._result: Table | None = None
        self.chunks_consumed = 0
        self.rows_consumed = 0
        self.cancelled = False
        self._exhausted = False

    @property
    def closed(self) -> bool:
        return self._result is not None

    @property
    def peak_buffered_chunks(self) -> int:
        return getattr(self._ex, "peak_buffered_chunks", 0)

    def stats(self) -> dict:
        """The unified ``repro.obs/v1`` telemetry schema: ingest counters,
        plus the executor's memory and device sections."""
        ingest = {
            "chunks_consumed": self.chunks_consumed,
            "rows_consumed": self.rows_consumed,
        }
        out = dict(ingest)
        if self._ex is not None:
            out.update(self._ex.stats())
        out["ingest"] = ingest
        out.setdefault("schema", "repro.obs/v1")
        return out

    def _dispatch(self, chunk: Table) -> None:
        with trace.span("consume_async", chunk=self.chunks_consumed):
            token = self._ex.consume_async(chunk)
        self.chunks_consumed += 1
        self.rows_consumed += chunk.num_rows
        if token is not None:
            self._inflight.append(token)
        while len(self._inflight) > self._prefetch:
            with trace.span("poll"):
                self._ex.poll(self._inflight.popleft())

    def _drain_inflight(self) -> None:
        while self._inflight:
            with trace.span("poll"):
                self._ex.poll(self._inflight.popleft())

    def pump(self, max_chunks: int | None = None) -> int:
        """Pull and consume up to ``max_chunks`` chunks (all when None);
        returns how many were consumed."""
        if self.cancelled:
            raise ValueError("stream cancelled")
        if self.closed:
            raise ValueError("stream already finalized via result()")
        n = 0
        with trace.span("pump", max_chunks=max_chunks):
            while max_chunks is None or n < max_chunks:
                chunk = next(self._chunks, None)
                if chunk is None:
                    self._exhausted = True
                    break
                self._dispatch(chunk)
                n += 1
        return n

    def save(self, path: str, *, step: int | None = None) -> str:
        """Checkpoint the live stream under ``path`` (atomic commit — a
        crash mid-save never corrupts the previous commit) and keep
        consuming.  Resume with :meth:`GroupByPlan.restore`, on this device
        or another.  Returns the committed directory."""
        from repro_torch.engine.elastic import save_stream

        return save_stream(self, path, step=step)

    def snapshot(self) -> Table:
        """Materialize the groups aggregated so far without closing the
        stream (drains the in-flight window first)."""
        if self.cancelled:
            raise ValueError("stream cancelled")
        if self.closed:
            return self._result
        with trace.span("snapshot"):
            self._drain_inflight()
            return self._ex.finalize()

    def result(self) -> Table:
        """Drain the source, settle in-flight chunks, finalize, close."""
        if self.cancelled:
            raise ValueError("stream cancelled")
        if not self.closed:
            self.pump()
            with trace.span("finalize"):
                self._drain_inflight()
                self._result = self._ex.finalize()
        return self._result

    # -- SlotTask face (serving scheduler) ----------------------------------

    @property
    def executor(self):
        return self._ex

    @property
    def done(self) -> bool:
        return self.closed or self.cancelled or self._exhausted

    def step(self) -> bool:
        """Pump a single chunk; False when the source is exhausted."""
        if self.done:
            return False
        return self.pump(1) == 1

    def finish(self) -> Table:
        return self.result()

    def cancel(self) -> None:
        """Abandon the stream and release the executor's device state."""
        self.cancelled = True
        self._inflight.clear()
        self._ex = None
        self._chunks = iter(())

    def pull_chunk(self) -> Table | None:
        """Pull the next chunk WITHOUT dispatching it (batched dispatch
        seam), updating the ingest counters."""
        if self.cancelled or self.closed:
            return None
        chunk = next(self._chunks, None)
        if chunk is None:
            self._exhausted = True
            return None
        self.chunks_consumed += 1
        self.rows_consumed += chunk.num_rows
        return chunk


def execute(plan: GroupByPlan, table: Table) -> Table:
    """One-shot execution: the whole table as a single chunk."""
    return plan.collect(table)


def value_columns(aggs: Sequence[AggSpec]) -> tuple:
    """Sorted value-column names a query's aggregates read."""
    return tuple(sorted({c for c, _ in expand_agg_specs(aggs) if c is not None}))


def as_group_result(out: Table, agg: AggSpec):
    """The uniform ``Table`` result → the legacy ``GroupByResult`` (keys in
    ticket order, one aggregate vector, scalar group count)."""
    from repro_torch.core.aggregation import GroupByResult

    return GroupByResult(out["key"], out[agg.name], out["__num_groups__"][0])


def arrays_as_table(keys: torch.Tensor, values: torch.Tensor | None) -> tuple:
    """The array calling convention ``(keys, values?)`` → a (Table,
    value-column-names) pair for a ``raw_keys`` plan; 2-D values become one
    column per trailing dim."""
    keys = to_i32_bits(torch.as_tensor(keys))
    n = keys.shape[0]
    if values is None:
        values = torch.ones((n,), dtype=torch.float32, device=keys.device)
    values = torch.as_tensor(values)
    if values.dim() > 1 and values.reshape(n, -1).shape[1] > 1:
        values = values.reshape(n, -1)
        cols = {f"v{i}": values[:, i].to(torch.float32) for i in range(values.shape[1])}
    else:
        cols = {"v": values.reshape(-1).to(torch.float32)}
    return Table({"__key__": keys, **cols}), tuple(cols)


__all__ = [
    "AggSpec",
    "ExecutionPolicy",
    "GroupByOverflowError",
    "GroupByPlan",
    "KERNELS",
    "SaturationPolicy",
    "STRATEGIES",
    "StreamHandle",
    "arrays_as_table",
    "as_group_result",
    "execute",
    "iter_chunks",
    "value_columns",
]
