"""Serving: the generic slot scheduler and the multi-tenant GROUP BY
server (port of ``repro.serve``; the LM decode loop ``engine.py`` comes
with the LM stack)."""
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
