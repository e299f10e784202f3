"""Span tracing → Chrome trace-event JSON (loadable in Perfetto / chrome://tracing).

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("consume", chunk=3):
        ...
    trace.save("stream.trace.json")

Spans become ``"ph": "X"`` *complete* events (ts/dur in microseconds, the
format Perfetto's Chrome-trace importer expects); :func:`instant` emits
``"ph": "i"`` markers.  Disabled (the default), :func:`span` returns a shared
no-op context manager and records nothing — the hot path pays one ``if``.

The buffer is process-wide and thread-safe; ``pid``/``tid`` are real so
scheduler quanta from worker threads land on their own Perfetto tracks.
"""
from __future__ import annotations

import json
import os
import threading
import time

_enabled = False
_lock = threading.Lock()
_events: list = []


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _events.clear()


def events() -> list:
    with _lock:
        return list(_events)


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name, args):
        self.name, self.args = name, args

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        end = _now_us()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": self.t0,
            "dur": end - self.t0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self.args:
            ev["args"] = self.args
        with _lock:
            _events.append(ev)
        return False


def span(name: str, **args):
    """Context manager timing one span. No-op (shared singleton) when disabled."""
    if not _enabled:
        return _NOOP_SPAN
    return _Span(name, args)


def instant(name: str, **args) -> None:
    """A zero-duration marker event."""
    if not _enabled:
        return
    ev = {
        "name": name,
        "ph": "i",
        "ts": _now_us(),
        "s": "t",
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def to_json() -> dict:
    """The Chrome trace-event JSON object (``traceEvents`` container form)."""
    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def save(path: str) -> str:
    """Write the trace to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_json(), f)
    return path
