"""Process-wide metrics registry + the device-side event vector layout.

Two halves, one file:

* A lightweight registry of **counters / gauges / histograms** with labeled
  series (``strategy=...``, ``tenant=...``, ``query=...``).  Disabled by
  default: every accessor returns a shared no-op instrument until
  :func:`enable` is called, so the off path costs one ``if`` and allocates
  nothing (the bench gate demands ≈0% overhead disabled, ≤5% enabled).

* The layout of the **device-side event counter vector** that the fused
  kernel (``kernels/fused_groupby.py``) accumulates per program: one
  ``(EVENT_VEC_LEN,)`` int32 row per program, carried across launches and
  read back only at host sync points the engine already has (finalize / an
  explicit ``event_counts()``).  Slots::

      [0..NUM_EVENTS)                  scalar event counters (EVT_*)
      [NUM_EVENTS..EVENT_VEC_LEN)      probe-length histogram buckets

  Counting semantics are *committed-morsel only*: a morsel that pauses (grow
  needed / probe table saturated) commits no accumulator state, so its row /
  probe counts are dropped exactly like its updates and the replay after
  migration counts it once.  ``EVT_PAUSES`` / ``EVT_PROBE_SATURATIONS`` are
  the exceptions — they count the pause events themselves.

Registry publishing from repeated snapshots is **delta-based** (see
:class:`EventPublisher`): ``finalize``/``snapshot`` are idempotent in the
engine, so publishers remember the last total they pushed and add only the
difference.
"""
from __future__ import annotations

import threading
from typing import Mapping, Sequence

# --------------------------------------------------------------------------
# Device-side event vector layout (must stay in sync with the fused kernel).
# --------------------------------------------------------------------------
EVT_MORSELS = 0            # committed morsels
EVT_ROWS = 1               # committed valid rows (key != EMPTY sentinel)
EVT_ROWS_MASKED = 2        # committed masked/padding rows
EVT_PROBE_STEPS = 3        # total probe-loop slot inspections (committed)
EVT_PROBE_SATURATIONS = 4  # morsels that hit a saturated probe table
EVT_PAUSES = 5             # pause events (grow / bound / saturation halts)
NUM_EVENTS = 6

# Probe-length histogram: bucket edges chosen so the paper-style operational
# read ("how long are probes under zipf vs uniform?") is one glance:
# lengths 1, 2, 3, 4, 5-8, 9-16, 17-32, 33+.
PROBE_HIST_EDGES: tuple = (2, 3, 4, 5, 9, 17, 33)
PROBE_HIST_BUCKETS = len(PROBE_HIST_EDGES) + 1
EVENT_VEC_LEN = NUM_EVENTS + PROBE_HIST_BUCKETS

EVENT_NAMES = (
    "morsels",
    "rows",
    "rows_masked",
    "probe_steps",
    "probe_saturations",
    "pauses",
)

PROBE_HIST_LABELS = ("1", "2", "3", "4", "5-8", "9-16", "17-32", "33+")


def zero_event_vector(device=None):
    """A fresh all-zero event vector (int32) on ``device``."""
    import torch

    return torch.zeros((EVENT_VEC_LEN,), dtype=torch.int32, device=device)


def event_vector_to_dict(vec) -> dict:
    """Split a host-side event vector into named counters + histogram list."""
    vals = [int(v) for v in vec]
    out = {name: vals[i] for i, name in enumerate(EVENT_NAMES)}
    out["probe_hist"] = vals[NUM_EVENTS:EVENT_VEC_LEN]
    return out


# --------------------------------------------------------------------------
# Enable flag + no-op fast path.
# --------------------------------------------------------------------------
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


class _Noop:
    """Shared do-nothing instrument returned while the registry is disabled."""

    __slots__ = ()

    def add(self, value=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    def add_counts(self, counts):
        pass


NOOP = _Noop()


# --------------------------------------------------------------------------
# Registry.
# --------------------------------------------------------------------------
def _label_key(labels: Mapping[str, object]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("_store", "_key")

    def __init__(self, store, key):
        self._store, self._key = store, key

    def add(self, value=1):
        with _REGISTRY._lock:
            self._store[self._key] = self._store.get(self._key, 0) + value


class Gauge:
    __slots__ = ("_store", "_key")

    def __init__(self, store, key):
        self._store, self._key = store, key

    def set(self, value):
        with _REGISTRY._lock:
            self._store[self._key] = value


class Histogram:
    """Fixed-bucket histogram; bucket edges are part of the series identity."""

    __slots__ = ("_store", "_key", "_edges")

    def __init__(self, store, key, edges):
        self._store, self._key, self._edges = store, key, tuple(edges)

    def observe(self, value):
        import bisect

        idx = bisect.bisect_right(self._edges, value)
        self.add_counts([1 if i == idx else 0 for i in range(len(self._edges) + 1)])

    def add_counts(self, counts: Sequence[int]):
        n = len(self._edges) + 1
        assert len(counts) == n, (len(counts), n)
        with _REGISTRY._lock:
            cur = self._store.get(self._key)
            if cur is None:
                cur = {"edges": list(self._edges), "counts": [0] * n}
                self._store[self._key] = cur
            cur["counts"] = [a + int(b) for a, b in zip(cur["counts"], counts)]


class Registry:
    def __init__(self):
        self._lock = threading.RLock()
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}

    def clear(self):
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    def snapshot(self) -> dict:
        """Plain-dict dump: {kind: {name: {"label=value,...": value}}}."""
        def fmt(key):
            name, labels = key
            lbl = ",".join(f"{k}={v}" for k, v in labels)
            return name, lbl

        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for key, v in self.counters.items():
                name, lbl = fmt(key)
                out["counters"].setdefault(name, {})[lbl] = v
            for key, v in self.gauges.items():
                name, lbl = fmt(key)
                out["gauges"].setdefault(name, {})[lbl] = v
            for key, v in self.histograms.items():
                name, lbl = fmt(key)
                out["histograms"].setdefault(name, {})[lbl] = {
                    "edges": list(v["edges"]), "counts": list(v["counts"]),
                }
        return out


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def clear() -> None:
    _REGISTRY.clear()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def counter(name: str, **labels):
    if not _enabled:
        return NOOP
    return Counter(_REGISTRY.counters, (name, _label_key(labels)))


def gauge(name: str, **labels):
    if not _enabled:
        return NOOP
    return Gauge(_REGISTRY.gauges, (name, _label_key(labels)))


def histogram(name: str, edges: Sequence[int], **labels):
    if not _enabled:
        return NOOP
    return Histogram(_REGISTRY.histograms, (name, _label_key(labels)), edges)


# --------------------------------------------------------------------------
# Delta-based publishing of monotonically growing totals.
# --------------------------------------------------------------------------
class EventPublisher:
    """Publishes monotone *totals* into registry counters as deltas.

    Engine surfaces (``finalize``, ``snapshot``, ``stats``) are idempotent,
    so the same totals can be observed many times; the publisher remembers
    the last value pushed per counter and adds only the difference.
    """

    def __init__(self, **labels):
        self.labels = labels
        self._last: dict = {}

    def publish(self, totals: Mapping[str, object]) -> None:
        if not _enabled:
            return
        for name, value in totals.items():
            if isinstance(value, (list, tuple)):  # histogram counts
                prev = self._last.get(name, [0] * len(value))
                delta = [int(v) - int(p) for v, p in zip(value, prev)]
                if any(delta):
                    histogram(name, PROBE_HIST_EDGES, **self.labels).add_counts(delta)
                self._last[name] = [int(v) for v in value]
            else:
                prev = self._last.get(name, 0)
                delta = int(value) - int(prev)
                if delta:
                    counter(name, **self.labels).add(delta)
                self._last[name] = int(value)
