"""Multi-tenant aggregation serving: many concurrent GROUP BY streams,
one scheduler, shared devices.

Port of ``repro.serve.query_server``.  ``AggregationServer`` is the
query-side client of the generic slot scheduler (``serve/scheduler.py``):
admit many streaming GROUP BY queries, step them fairly across tenants,
batch same-shape queries into one ticket launch, and enforce per-tenant
capacity budgets.

    server = AggregationServer(slots=8)
    h1 = server.submit(plan, source_a, tenant="alice")
    h2 = server.submit(plan, source_b, tenant="bob")
    partial = h1.snapshot()       # incremental per-query read, mid-stream
    out1 = h1.result()            # drives the scheduler (fairly) to h1's end
    h2.cancel()                   # frees the slot; queued queries admit

Each submitted query is a ``GroupByPlan.stream()`` handle wearing its
``SlotTask`` face: one scheduling quantum = one source chunk through the
executor.  Queries whose plans share a ``batch_signature``
(engine/executors.py) advertise it as their ``batch_key``, so the scheduler
steps the whole group through ``consume_batched``: one
``scan_ticket_batched`` launch and one blocking read for the round's N
chunks, where solo stepping costs N launches and N reads.  The server has
no device setting of its own: each plan's ``ExecutionPolicy.device``
decides where its query runs.

Budgets ride the ``SaturationPolicy`` seam: a tenant with ``max_groups=B``
gets every plan capped at B **with saturation forced to RAISE**, so the
offending query fails with ``GroupByOverflowError`` at its finalize while
every other query keeps running (the scheduler isolates task failures per
slot).  A plan submitted with ``saturation="spill"`` instead treats the cap
as its device residency and spills the cold tail to host
(engine/spill.py), completing with exact totals.

Recovery: before each quantum a sharded stream whose mesh holds failed
members re-buckets onto the survivors in place (``engine/elastic.py``),
while the other tenants keep stepping.  A query submitted with
``checkpoint_dir`` / ``checkpoint_every`` commits its stream on that
cadence, and a quantum that raises
:class:`~repro_torch.train.elastic.WorkerFailure` restores from the last
commit; with no commit the failure stays on its slot.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.engine.plan_api import GroupByPlan, SaturationPolicy, StreamHandle
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.scheduler import (
    CANCELLED,
    DONE,
    FAILED,
    QueueFullError,
    Scheduler,
    SlotHandle,
    TenantBudget,
)
from repro_torch.train.elastic import WorkerFailure


@dataclass
class _QueryTask:
    """``SlotTask`` over a :class:`StreamHandle`, plus the batched-dispatch
    group key.  Solo stepping pumps through the handle's prefetch window;
    group stepping pulls one chunk per live handle and tickets them all in
    one launch (``engine.executors.consume_batched``).

    Fault tolerance (``engine/elastic.py``): before each quantum a sharded
    stream whose mesh holds failed members re-buckets onto the survivors
    in place (counted in ``remeshes``), and keeps running while other
    tenants keep stepping.  A stream whose quantum raises
    :class:`~repro_torch.train.elastic.WorkerFailure` instead restores from
    its last checkpoint commit (``checkpoint_dir`` / ``checkpoint_every``
    on ``submit``); with no commit to fall back to, the failure propagates
    and the scheduler isolates it to this slot.  A batched round neither
    checkpoints nor restores, as in the reference."""

    handle: StreamHandle
    batch_key: Any = None
    plan: GroupByPlan | None = None
    source: Any = None
    checkpoint_dir: str | None = None
    checkpoint_every: int | None = None
    tenant: str = "default"
    remeshes: int = 0
    restores: int = 0
    _last_saved: int = field(default=0, repr=False)

    @property
    def done(self) -> bool:
        return self.handle.done

    # -- recovery ------------------------------------------------------------

    def _count(self, kind: str) -> None:
        if obs_metrics.enabled():
            obs_metrics.counter(
                "serve.recovery", tenant=self.tenant, kind=kind
            ).add(1)

    def _maybe_remesh(self) -> None:
        """Proactive loss check for meshed (sharded) streams: re-bucket onto
        the survivor mesh at the quantum boundary.  Total loss falls through
        to the checkpoint-restore path."""
        from repro_torch.engine import elastic as streams

        mesh = streams.stream_mesh(self.handle)
        if mesh is None or not streams.mesh_failed_ids(mesh):
            return
        try:
            if streams.remesh_stream(self.handle):
                self.remeshes += 1
                self._count("remesh")
        except WorkerFailure as err:
            self._restore_from_checkpoint(err)

    def _restore_from_checkpoint(self, err: WorkerFailure) -> None:
        """Swap the handle for one restored from the last commit; with no
        commit (or no checkpoint_dir) the failure propagates."""
        from repro_torch.checkpoint.manager import latest_commit_step

        if (self.plan is None or self.checkpoint_dir is None
                or latest_commit_step(self.checkpoint_dir) is None):
            raise err
        old = self.handle
        self.handle = self.plan.restore(self.checkpoint_dir, self.source)
        old.cancel()  # release the failed executor's device state
        self._last_saved = self.handle.chunks_consumed
        self.restores += 1
        self._count("restore")

    def _maybe_checkpoint(self) -> None:
        h = self.handle
        if (self.checkpoint_dir is None or not self.checkpoint_every
                or h.closed or h.cancelled):
            return
        if h.chunks_consumed - self._last_saved >= self.checkpoint_every:
            h.save(self.checkpoint_dir)
            self._last_saved = h.chunks_consumed

    def step(self) -> None:
        self._maybe_remesh()
        try:
            self.handle.step()
        except WorkerFailure as err:
            self._restore_from_checkpoint(err)
            return
        self._maybe_checkpoint()

    @staticmethod
    def step_batch(tasks: list["_QueryTask"]) -> None:
        """One chunk of every live task.  Each lane first settles its
        handle's in-flight chunks (earlier solo quanta), in dispatch order,
        so the batched chunk lands on a resolved table."""
        from repro_torch.engine.executors import consume_batched

        pairs = []
        for t in tasks:
            if t.done:
                continue
            t._maybe_remesh()
            t.handle._drain_inflight()
            chunk = t.handle.pull_chunk()
            if chunk is not None:
                pairs.append((t, chunk))
        if not pairs:
            return
        if len(pairs) == 1:
            t, chunk = pairs[0]
            t.handle.executor.consume(chunk)
            return
        consume_batched(
            [t.handle.executor for t, _ in pairs],
            [chunk for _, chunk in pairs],
        )

    def finish(self):
        self._maybe_remesh()
        try:
            return self.handle.finish()
        except WorkerFailure as err:
            self._restore_from_checkpoint(err)
            return self.handle.finish()

    def cancel(self) -> None:
        self.handle.cancel()


class QueryHandle:
    """One live (or finished) query on the server.  Reads its stream
    through the slot task, so a recovery that swaps the underlying handle
    (checkpoint restore) stays transparent to the caller."""

    def __init__(self, server: "AggregationServer", slot: SlotHandle,
                 task: _QueryTask):
        self._server = server
        self._slot = slot
        self._task = task

    @property
    def _stream(self) -> StreamHandle:
        return self._task.handle

    @property
    def tenant(self) -> str:
        return self._slot.tenant

    @property
    def status(self) -> str:
        return self._slot.status

    @property
    def done(self) -> bool:
        return self._slot.terminal

    @property
    def error(self) -> BaseException | None:
        return self._slot.error

    @property
    def slot(self) -> int | None:
        return self._slot.slot

    @property
    def chunks_consumed(self) -> int:
        return self._stream.chunks_consumed

    def stats(self) -> dict:
        """This query's ingest + memory telemetry
        (:meth:`repro_torch.engine.plan_api.StreamHandle.stats`): chunk/row
        counters, retention high-water marks, and spill accounting when the
        plan runs out-of-core."""
        return self._stream.stats()

    def profile(self) -> dict:
        """Per-query execution profile, readable at any point in the
        query's lifecycle (queued, running, terminal): wall/queue wall-clock
        seconds from the slot handle, scheduling quanta received, ingest
        progress, the executor's current device-table footprint, and the
        full unified ``stats()`` payload nested under ``"stats"``."""
        slot, stream = self._slot, self._stream
        stats = stream.stats()
        return {
            "tenant": slot.tenant,
            "status": slot.status,
            "wall_time_s": slot.wall_time_s,
            "queue_wait_s": slot.queue_wait_s,
            "quanta": slot.steps,
            "chunks": stream.chunks_consumed,
            "rows": stream.rows_consumed,
            "device_table_bytes": stats.get("device", {}).get(
                "device_table_bytes", 0
            ),
            "recoveries": {
                "remeshes": self._task.remeshes,
                "restores": self._task.restores,
            },
            "stats": stats,
        }

    def snapshot(self):
        """Incremental per-query read: the groups this query has aggregated
        so far, without disturbing its stream (idempotent executor
        finalize).  On a finished query this is simply its result."""
        if self._slot.status == DONE:
            return self._slot.value
        if self._slot.status in (FAILED, CANCELLED):
            return self._slot.result()  # raises the stored error
        return self._stream.snapshot()

    def result(self):
        """Drive the scheduler — fairly, every tenant keeps advancing —
        until THIS query is terminal; return its table or raise its
        error."""
        if not self._slot.terminal:
            self._server.scheduler.drive(self._slot)
        return self._slot.result()

    def cancel(self) -> None:
        """Cancel the query: its executor state is released and its slot is
        immediately free for the next queued admission."""
        self._server.scheduler.cancel(self._slot)


class AggregationServer:
    """Multiplex concurrent GROUP BY streams over shared devices."""

    def __init__(self, *, slots: int = 8, batch_queries: bool = True):
        self.scheduler = Scheduler(slots=slots)
        self.batch_queries = batch_queries

    # -- tenants ------------------------------------------------------------

    def set_budget(self, tenant: str, *, max_groups: int | None = None,
                   weight: int = 1, max_steps: int | None = None,
                   max_queue_depth: int | None = None) -> None:
        """Per-tenant contract: ``weight`` quanta per round-robin turn,
        ``max_steps`` hard scheduling budget, ``max_groups`` hard per-query
        cardinality cap (enforced through ``SaturationPolicy.RAISE``; a
        ``saturation="spill"`` plan instead treats the cap as its device
        residency budget and completes exactly by spilling to host), and
        ``max_queue_depth`` admission control — a ``submit`` that would put
        more than that many of the tenant's queries in the waiting queue is
        refused with :class:`~repro_torch.serve.scheduler.QueueFullError`."""
        self.scheduler.set_budget(
            tenant,
            TenantBudget(weight=weight, max_steps=max_steps,
                         max_groups=max_groups,
                         max_queue_depth=max_queue_depth),
        )

    def tenant_stats(self, tenant: str) -> dict:
        return self.scheduler.tenant_stats(tenant)

    # -- queries ------------------------------------------------------------

    def _apply_budget(self, plan: GroupByPlan, tenant: str) -> GroupByPlan:
        budget = self.scheduler.budget(tenant)
        if budget is None or budget.max_groups is None:
            return plan
        capped = (
            budget.max_groups if plan.max_groups is None
            else min(plan.max_groups, budget.max_groups)
        )
        if plan.saturation == SaturationPolicy.SPILL:
            # A spilling query honors the budget as a device residency cap:
            # the hot table stays within it and the cold tail goes to host,
            # so the query completes exactly instead of raising.
            return plan.with_(max_groups=capped)
        # A budget is a hard per-tenant contract: the capped plan must
        # surface saturation, not silently grow past it or truncate.
        return plan.with_(max_groups=capped, saturation=SaturationPolicy.RAISE)

    def submit(self, plan: GroupByPlan, source, *, tenant: str = "default",
               prefetch: int | None = None,
               checkpoint_dir: str | None = None,
               checkpoint_every: int | None = None) -> QueryHandle:
        """Admit a streaming GROUP BY: free slot → runs on the next
        scheduling round; otherwise queued until a slot frees.  Nothing is
        consumed from ``source`` until the query is stepped.  A tenant at
        its ``max_queue_depth`` is refused with :class:`QueueFullError`
        and the stream is cancelled.

        ``checkpoint_dir`` (+ ``checkpoint_every`` chunks) arms the
        restore-on-failure recovery path: the query checkpoints its
        executor state on that cadence, and a quantum that raises
        :class:`~repro_torch.train.elastic.WorkerFailure` resumes from the
        last commit instead of failing the slot (requires a re-iterable
        ``source``; see ``engine/elastic.py``).  Sharded streams also
        re-mesh onto surviving members in place, checkpoint or not."""
        from repro_torch.engine.executors import batch_signature

        plan = self._apply_budget(plan, tenant)
        sig = batch_signature(plan) if self.batch_queries else None
        stream = plan.stream(source, prefetch=prefetch)
        task = _QueryTask(
            stream, batch_key=sig, plan=plan, source=source,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            tenant=tenant,
        )
        try:
            slot = self.scheduler.submit(task, tenant=tenant)
        except QueueFullError:
            stream.cancel()  # admission refused: release executor state
            raise
        return QueryHandle(self, slot, task)

    # -- driving ------------------------------------------------------------

    def step(self, rounds: int = 1) -> int:
        """Run up to ``rounds`` scheduling rounds; returns tasks stepped."""
        total = 0
        for _ in range(rounds):
            n = self.scheduler.step()
            if n == 0:
                break
            total += n
        return total

    def run_until_idle(self) -> int:
        """Drive every submitted query to a terminal state."""
        return self.scheduler.run_until_idle()

    @property
    def idle(self) -> bool:
        return self.scheduler.idle


__all__ = ["AggregationServer", "QueryHandle", "QueueFullError"]
