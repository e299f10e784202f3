"""Observability: the device event-vector layout, the metrics registry and
span tracing (pure Python copies of ``repro.obs``).

Everything is OFF by default; enable explicitly::

    from repro_torch.obs import metrics, trace
    metrics.enable()   # counters / gauges / histograms + device event vector
    trace.enable()     # spans → Perfetto-loadable Chrome trace JSON

or per plan with ``ExecutionPolicy(instrument=True)``.
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (
    EVENT_NAMES,
    EVENT_VEC_LEN,
    EVT_MORSELS,
    EVT_PAUSES,
    EVT_PROBE_SATURATIONS,
    EVT_PROBE_STEPS,
    EVT_ROWS,
    EVT_ROWS_MASKED,
    NUM_EVENTS,
    PROBE_HIST_BUCKETS,
    PROBE_HIST_EDGES,
    PROBE_HIST_LABELS,
    EventPublisher,
    event_vector_to_dict,
    zero_event_vector,
)

__all__ = [
    "metrics",
    "trace",
    "EVENT_NAMES",
    "EVENT_VEC_LEN",
    "EVT_MORSELS",
    "EVT_PAUSES",
    "EVT_PROBE_SATURATIONS",
    "EVT_PROBE_STEPS",
    "EVT_ROWS",
    "EVT_ROWS_MASKED",
    "NUM_EVENTS",
    "PROBE_HIST_BUCKETS",
    "PROBE_HIST_EDGES",
    "PROBE_HIST_LABELS",
    "EventPublisher",
    "event_vector_to_dict",
    "zero_event_vector",
]
