"""Observability: the device event-vector layout, the metrics registry and
span tracing (pure Python copies of ``repro.obs``)."""
