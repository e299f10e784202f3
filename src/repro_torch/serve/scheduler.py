"""The generic slot scheduler: one continuous-batching core, many clients.

Port of ``repro.serve.scheduler`` (pure Python, no device code).  The
streaming GROUP BY queries of ``serve/query_server.py``'s
``AggregationServer`` are its client here; the LM decode loop that also
rides it in the reference comes with the LM stack.

The contract is the :class:`SlotTask` protocol::

    submit → [queue] → admit (free slot) → step()* → finish() | cancel()

``step()`` is one scheduling quantum: for a decode task, one lock-step
token; for an aggregation task, one source chunk through the executor.
Tasks expose ``done`` (nothing left to step), ``finish()`` (materialize the
terminal result) and ``cancel()`` (drop state so the slot can be reused).

Scheduling is **deficit round-robin across tenants**: tenants rotate in
first-submission order and a tenant with runnable tasks gets
``TenantBudget.weight`` consecutive quanta before the turn advances, so no
tenant starves behind a longer stream (the fairness tests pin this).
Within a tenant the least-recently-stepped task runs first.

Batched dispatch: a task may advertise a hashable ``batch_key``.  When the
turn lands on a task whose key other runnable slots share, the whole group
steps through ONE ``step_batch(tasks)`` call — the seam the query server
uses to ticket N same-shape GROUP BY chunks in a single kernel launch
(``engine.executors.consume_batched``).  Every group member is
charged a quantum, so fairness accounting is unchanged.

Failure isolation: an exception from ``step()``/``finish()`` fails THAT
handle (stored on it, re-raised by ``result()``), releases its slot, and
admits from the queue — one saturated query must not take the server down.
Per-tenant accounting (quanta served) backs the optional
``TenantBudget.max_steps`` hard stop; ``TenantBudget.max_groups`` is read
at admission by the query server (enforced through the plan's
``SaturationPolicy`` seam, not here).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@runtime_checkable
class SlotTask(Protocol):
    """What the scheduler needs from a schedulable unit of work."""

    @property
    def done(self) -> bool:  # pragma: no cover - protocol
        ...

    def step(self) -> None:  # pragma: no cover - protocol
        """Run one scheduling quantum of work."""

    def finish(self) -> Any:  # pragma: no cover - protocol
        """Materialize the terminal result (called once, after ``done``)."""

    def cancel(self) -> None:  # pragma: no cover - protocol
        """Release task state; the task will never be stepped again."""

    # Optional extensions (looked up with getattr):
    #   batch_key: Hashable | None — runnable tasks sharing a non-None key
    #     step together through type(task).step_batch(tasks), one dispatch.


@dataclass(frozen=True)
class TenantBudget:
    """Per-tenant scheduling/capacity contract.

    weight:     consecutive quanta per round-robin turn (fair share knob).
    max_steps:  hard quantum budget across the tenant's queries; exceeding
                it fails the tenant's current task with
                :class:`BudgetExceededError` (others keep running).
    max_groups: per-query cardinality cap, enforced at admission by the
                query server through ``SaturationPolicy.RAISE`` — the
                scheduler itself never inspects query semantics.
    max_queue_depth: admission control beyond the slot count — the most
                tasks this tenant may have WAITING (queued, not yet in a
                slot).  ``submit`` past the bound raises
                :class:`QueueFullError` instead of growing the queue
                without limit; the caller sheds load or retries later.
    """

    weight: int = 1
    max_steps: int | None = None
    max_groups: int | None = None
    max_queue_depth: int | None = None


class BudgetExceededError(RuntimeError):
    """A tenant's scheduling budget (``TenantBudget.max_steps``) ran out."""


class QueueFullError(RuntimeError):
    """A tenant's waiting queue is at ``TenantBudget.max_queue_depth``;
    the submission was refused (nothing was enqueued)."""


class TaskCancelledError(RuntimeError):
    """``result()`` was read from a handle that was cancelled."""


# handle lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


@dataclass
class SlotHandle:
    """One submitted task's lifecycle, owned by the scheduler."""

    task: Any
    tenant: str
    status: str = QUEUED
    slot: int | None = None
    steps: int = 0
    last_step: int = -1        # scheduler clock of the latest quantum
    admitted_at: int = -1      # clock at slot admission
    finished_at: int = -1      # clock at terminal transition
    # wall-clock lifecycle (perf_counter seconds) backing QueryHandle.profile()
    submitted_ts: float = field(default_factory=time.perf_counter)
    admitted_ts: float | None = None
    finished_ts: float | None = None
    error: BaseException | None = None
    value: Any = None

    @property
    def terminal(self) -> bool:
        return self.status in (DONE, FAILED, CANCELLED)

    @property
    def queue_wait_s(self) -> float:
        """Wall seconds spent queued before slot admission (live for a
        still-queued handle)."""
        end = self.admitted_ts
        if end is None:
            end = (
                self.finished_ts if self.finished_ts is not None
                else time.perf_counter()
            )
        return max(end - self.submitted_ts, 0.0)

    @property
    def wall_time_s(self) -> float:
        """Wall seconds from submission to the terminal transition (live
        for a handle still in flight)."""
        end = (
            self.finished_ts if self.finished_ts is not None
            else time.perf_counter()
        )
        return max(end - self.submitted_ts, 0.0)

    def result(self) -> Any:
        """Terminal result; raises the stored error for failed handles.
        (The driving loop lives on the scheduler/server — a bare handle
        never advances itself.)"""
        if self.status == FAILED:
            raise self.error
        if self.status == CANCELLED:
            raise TaskCancelledError(f"task for tenant {self.tenant!r} was cancelled")
        if self.status != DONE:
            raise RuntimeError("task not finished; drive the scheduler first")
        return self.value


class Scheduler:
    """Free-slot admission + deficit round-robin fair stepping + batched
    dispatch over a fixed grid of ``slots``."""

    def __init__(self, slots: int):
        assert slots >= 1, slots
        self.slots = slots
        self.clock = 0
        self._slots: list[SlotHandle | None] = [None] * slots
        self._queue: deque[SlotHandle] = deque()
        self._budgets: dict[str, TenantBudget] = {}
        self._tenant_order: list[str] = []   # first-submission rotation order
        self._turn = 0                       # rotation cursor into _tenant_order
        self._turn_served = 0                # quanta served in the current turn
        self._tenant_steps: dict[str, int] = {}
        self._tenant_queue_wait: dict[str, float] = {}  # admitted handles only

    # -- budgets / stats ----------------------------------------------------

    def set_budget(self, tenant: str, budget: TenantBudget) -> None:
        self._budgets[tenant] = budget

    def budget(self, tenant: str) -> TenantBudget | None:
        return self._budgets.get(tenant)

    def tenant_stats(self, tenant: str) -> dict:
        live = [h for h in self._slots if h is not None and h.tenant == tenant]
        queued = [h for h in self._queue if h.tenant == tenant]
        return {
            "steps": self._tenant_steps.get(tenant, 0),
            "running": len(live),
            "queued": len(queued),
            # obs schema aliases + accumulated time-in-queue: ``queue_wait_s``
            # covers every ADMITTED handle plus the live wait of still-queued
            # ones, so it is monotone across a run
            "quanta": self._tenant_steps.get(tenant, 0),
            "queue_depth": len(queued),
            "queue_wait_s": self._tenant_queue_wait.get(tenant, 0.0)
            + sum(h.queue_wait_s for h in queued),
        }

    # -- admission ----------------------------------------------------------

    def submit(self, task: SlotTask, *, tenant: str = "default") -> SlotHandle:
        """Admit into a free slot, or queue until one frees.  A tenant at
        its ``max_queue_depth`` waiting bound is refused with
        :class:`QueueFullError` (nothing enqueued) — backpressure instead
        of an unbounded queue."""
        cap = self._budgets.get(tenant)
        if cap is not None and cap.max_queue_depth is not None:
            waiting = sum(1 for h in self._queue if h.tenant == tenant)
            if waiting >= cap.max_queue_depth:
                if obs_metrics.enabled():
                    obs_metrics.counter(
                        "scheduler.rejected", tenant=tenant
                    ).add(1)
                raise QueueFullError(
                    f"tenant {tenant!r} has {waiting} queued tasks, at its "
                    f"max_queue_depth={cap.max_queue_depth}; retry after the "
                    "backlog drains or raise the budget"
                )
        handle = SlotHandle(task=task, tenant=tenant)
        if tenant not in self._tenant_steps:
            self._tenant_steps[tenant] = 0
            self._tenant_order.append(tenant)
        self._queue.append(handle)
        self._admit()
        if obs_metrics.enabled():
            obs_metrics.gauge("scheduler.queue_depth", tenant=tenant).set(
                sum(1 for h in self._queue if h.tenant == tenant)
            )
        return handle

    def _admit(self) -> None:
        for i, occ in enumerate(self._slots):
            if not self._queue:
                return
            if occ is None:
                handle = self._queue.popleft()
                handle.slot = i
                handle.status = RUNNING
                handle.admitted_at = self.clock
                handle.admitted_ts = time.perf_counter()
                self._tenant_queue_wait[handle.tenant] = (
                    self._tenant_queue_wait.get(handle.tenant, 0.0)
                    + handle.queue_wait_s
                )
                self._slots[i] = handle

    def _release(self, handle: SlotHandle) -> None:
        if handle.slot is not None and self._slots[handle.slot] is handle:
            self._slots[handle.slot] = None
        handle.finished_at = self.clock
        handle.finished_ts = time.perf_counter()
        self._admit()

    # -- cancellation -------------------------------------------------------

    def cancel(self, handle: SlotHandle) -> None:
        """Cancel a queued or running handle: the task releases its state,
        the slot frees, and the next queued task admits immediately."""
        if handle.terminal:
            return
        if handle.status == QUEUED:
            try:
                self._queue.remove(handle)
            except ValueError:
                pass
        try:
            handle.task.cancel()
        except Exception:
            pass  # cancellation is best-effort; the slot frees regardless
        handle.status = CANCELLED
        self._release(handle)

    # -- stepping -----------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self._queue and all(h is None for h in self._slots)

    def _running(self) -> list[SlotHandle]:
        return [h for h in self._slots if h is not None and h.status == RUNNING]

    def _pick_tenant(self, running: list[SlotHandle]) -> str:
        runnable = {h.tenant for h in running}
        n = len(self._tenant_order)
        current = self._tenant_order[self._turn % n]
        weight = max(getattr(self._budgets.get(current), "weight", 1) or 1, 1)
        if current in runnable and self._turn_served < weight:
            return current
        # advance the rotation to the next tenant with runnable work
        for off in range(1, n + 1):
            cand = self._tenant_order[(self._turn + off) % n]
            if cand in runnable:
                self._turn = (self._turn + off) % n
                self._turn_served = 0
                return cand
        return current  # unreachable: running is non-empty

    def _fail(self, handle: SlotHandle, err: BaseException) -> None:
        handle.error = err
        handle.status = FAILED
        try:
            handle.task.cancel()
        except Exception:
            pass
        self._release(handle)

    def _retire(self, handle: SlotHandle) -> None:
        try:
            handle.value = handle.task.finish()
        except BaseException as err:  # GroupByOverflowError etc.
            self._fail(handle, err)
            return
        handle.status = DONE
        self._release(handle)

    def step(self) -> int:
        """One scheduling round: pick the next tenant's least-recently-
        stepped task, co-dispatch every runnable slot sharing its
        ``batch_key``, charge each a quantum, retire finished tasks and
        admit from the queue.  Returns the number of tasks stepped (0 when
        nothing is runnable)."""
        self._admit()
        running = self._running()
        if not running:
            return 0
        self.clock += 1
        tenant = self._pick_tenant(running)
        self._turn_served += 1
        mine = [h for h in running if h.tenant == tenant]
        primary = min(mine, key=lambda h: (h.last_step, h.slot))
        group = [primary]
        key = getattr(primary.task, "batch_key", None)
        if key is not None:
            group += [
                h for h in running
                if h is not primary and getattr(h.task, "batch_key", None) == key
            ]
        try:
            with obs_trace.span(
                "quantum", tenant=tenant, clock=self.clock, batch=len(group)
            ):
                if len(group) > 1:
                    type(primary.task).step_batch([h.task for h in group])
                else:
                    primary.task.step()
        except BaseException as err:
            for h in group:
                self._fail(h, err)
            return len(group)
        stepped = len(group)
        if obs_metrics.enabled():
            obs_metrics.counter("scheduler.quanta", tenant=tenant).add(stepped)
            depth: dict[str, int] = {t: 0 for t in self._tenant_order}
            for h in self._queue:
                depth[h.tenant] = depth.get(h.tenant, 0) + 1
            for t, d in depth.items():
                obs_metrics.gauge("scheduler.queue_depth", tenant=t).set(d)
        for h in group:
            h.steps += 1
            h.last_step = self.clock
            self._tenant_steps[h.tenant] = self._tenant_steps.get(h.tenant, 0) + 1
            cap = self._budgets.get(h.tenant)
            if (cap is not None and cap.max_steps is not None
                    and self._tenant_steps[h.tenant] > cap.max_steps):
                self._fail(h, BudgetExceededError(
                    f"tenant {h.tenant!r} exceeded its scheduling budget of "
                    f"{cap.max_steps} quanta"
                ))
        for h in group:
            if h.status == RUNNING and h.task.done:
                self._retire(h)
        return stepped

    def run_until_idle(self, max_rounds: int | None = None) -> int:
        """Step until every submitted task reached a terminal state.
        Returns the number of rounds run."""
        rounds = 0
        while not self.idle:
            if max_rounds is not None and rounds >= max_rounds:
                break
            if self.step() == 0 and self._queue:
                raise RuntimeError(
                    "scheduler stuck: queued tasks but no runnable slot"
                )
            rounds += 1
        return rounds

    def drive(self, handle: SlotHandle) -> Any:
        """Step (fairly — every tenant keeps advancing) until ``handle``
        is terminal, then return its result or raise its error."""
        while not handle.terminal:
            if self.step() == 0:
                raise RuntimeError("scheduler idle but handle not terminal")
        return handle.result()


__all__ = [
    "BudgetExceededError",
    "QueueFullError",
    "Scheduler",
    "SlotHandle",
    "SlotTask",
    "TaskCancelledError",
    "TenantBudget",
]
