"""What one run recorded, as the metric readers see it.  Times on the host
are ``time.perf_counter`` microseconds; device operations are put on the
same clock."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Query:
    seconds: float            # opening the stream → result, synchronized
    rows: int
    ok: bool
    peak_bytes: int | None = None   # requested above the query's start
    stats: dict | None = None       # StreamHandle.stats() (traced runs)


@dataclass
class Run:
    cell: str
    setup_s: float
    window_start_us: float
    window_end_us: float
    queries: list = field(default_factory=list)
    spans: list = field(default_factory=list)      # host spans (traced runs)
    device_ops: list | None = None                 # device spans (traced runs)
    query_bytes: int | None = None                 # least bytes of one query
    hbm_bytes_per_s: float | None = None

    @property
    def window_s(self) -> float:
        return (self.window_end_us - self.window_start_us) / 1e6

    @property
    def done(self) -> list:
        return [q for q in self.queries if q.ok]

    def span_us(self, *names: str, outside: tuple = ()) -> float:
        """Summed microseconds of the spans named ``names``, leaving out
        those that lie inside a span named in ``outside``."""
        outer = [s for s in self.spans if s.name in outside]
        total = 0.0
        for s in self.spans:
            if s.name in names and not any(
                    o.start_us <= s.start_us and s.end_us <= o.end_us for o in outer):
                total += s.us
        return total
