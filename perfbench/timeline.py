"""Reading a traced window: device operations from the profiler, the busy
and idle time they leave, and what the host was doing in each idle gap."""
from __future__ import annotations

import time
from collections import defaultdict

from perfbench.record import Span

OUTSIDE = "between_queries"


def _on(e, device: str) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == device


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def wall_minus_perf_ns() -> int:
    """The wall clock (which the profiler stamps) less ``perf_counter``."""
    return time.time_ns() - time.perf_counter_ns()


def device_ops(prof, offset_ns: int) -> list:
    """The profiler's device operations as spans on the host's
    ``perf_counter`` clock, given the wall clock's offset from it."""
    return [Span(e.name(), (e.start_ns() - offset_ns) / 1e3,
                 (e.start_ns() + e.duration_ns() - offset_ns) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if _on(e, "CUDA") and not _annotation(e)]


def merged(spans, lo: float, hi: float) -> list:
    """The union of ``spans`` clipped to ``[lo, hi]``, as sorted pairs."""
    out: list = []
    for s, e in sorted((max(x.start_us, lo), min(x.end_us, hi)) for x in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(spans, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(spans, lo, hi))


def idle_gaps(spans, lo: float, hi: float) -> list:
    """The intervals of ``[lo, hi]`` in which no device operation ran."""
    out, t = [], lo
    for s, e in merged(spans, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans) -> list:
    """Nested host spans → sorted, disjoint ``(start, end, name)`` segments
    of the innermost span open at each moment."""
    segs: list = []
    stack: list = []
    t = None
    for sp in sorted(spans, key=lambda x: (x.start_us, -x.end_us)):
        while stack and stack[-1].end_us <= sp.start_us:
            top = stack.pop()
            if top.end_us > t:
                segs.append((t, top.end_us, top.name))
                t = top.end_us
        if stack and sp.start_us > t:
            segs.append((t, sp.start_us, stack[-1].name))
        t = sp.start_us if t is None else max(t, sp.start_us)
        stack.append(sp)
    while stack:
        top = stack.pop()
        if top.end_us > t:
            segs.append((t, top.end_us, top.name))
            t = top.end_us
    return segs


def idle_by_host(gaps, host_spans) -> dict:
    """Idle microseconds by the innermost host span open during them; time
    under no span counts as ``between_queries``."""
    segs = innermost(host_spans)
    out: dict = defaultdict(float)
    i = 0
    for s, e in gaps:
        while i < len(segs) and segs[i][1] <= s:
            i += 1
        covered, j = 0.0, i
        while j < len(segs) and segs[j][0] < e:
            part = min(e, segs[j][1]) - max(s, segs[j][0])
            if part > 0:
                out[segs[j][2]] += part
                covered += part
            j += 1
        if e - s > covered:
            out[OUTSIDE] += e - s - covered
    return dict(out)


def by_name_us(spans) -> dict:
    out: dict = defaultdict(float)
    for s in spans:
        out[s.name] += s.us
    return dict(out)


def top(us_by_name: dict, k: int = 10) -> list:
    """The ``k`` largest entries as ``[name, seconds]``, largest first."""
    ranked = sorted(us_by_name.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[name[:200], us / 1e6] for name, us in ranked]
