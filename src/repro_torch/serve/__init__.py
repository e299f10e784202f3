"""Serving: the generic slot scheduler, the multi-tenant GROUP BY server
and the LM decode loop (port of ``repro.serve``; ``engine.py``'s
``ServeLoop`` and ``Request`` are imported from ``repro_torch.serve.engine``,
as in the reference)."""
from repro_torch.serve.query_server import AggregationServer, QueryHandle
from repro_torch.serve.scheduler import (
    BudgetExceededError,
    QueueFullError,
    Scheduler,
    SlotHandle,
    SlotTask,
    TaskCancelledError,
    TenantBudget,
)

__all__ = [
    "AggregationServer",
    "BudgetExceededError",
    "QueryHandle",
    "QueueFullError",
    "Scheduler",
    "SlotHandle",
    "SlotTask",
    "TaskCancelledError",
    "TenantBudget",
]
