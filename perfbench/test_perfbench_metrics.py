"""The metric readers and the trace reading on a canned run."""
import statistics

import pytest

from perfbench import harness, roofline, timeline
from perfbench.record import Query, Run, Span


def read(name, run):
    return harness._load("metrics", name).read(run)


def canned(traced=True):
    """Two queries of 10 ms and a failed one in a 25-ms window (µs 1000 →
    26000); a traced run also has spans, device operations and stats."""
    q = [Query(0.010, 1000, True, peak_bytes=3 * 2**20,
               stats={"device": {"migrations": 2, "bound_grows": 1, "device_table_bytes": 2**20}}),
         Query(0.010, 1000, True, peak_bytes=5 * 2**20,
               stats={"device": {"migrations": 0, "bound_grows": 1, "device_table_bytes": 2**21}}),
         Query(0.003, 1000, False)]
    run = Run(cell="c", setup_s=4.5, window_start_us=1000.0, window_end_us=26000.0, queries=q)
    if not traced:
        for x in q:
            x.stats = None
    else:
        run.spans = [
            Span("query", 1000, 11000), Span("query", 14000, 24000),
            Span("consume_async", 1000, 3000), Span("poll", 3000, 4000),
            Span("finalize", 9000, 11000), Span("poll", 9500, 10500),
            Span("pause_migrate_resume", 3200, 3700),
            Span("consume_async", 14000, 15000), Span("finalize", 20000, 24000),
        ]
        run.device_ops = [Span("k1", 2000, 6000), Span("k2", 5000, 8000),
                          Span("k1", 16000, 20000), Span("copy", 25000, 27000)]
        run.query_bytes = 10**9
        run.hbm_bytes_per_s = 1e13
    return run


def test_end_to_end_readers():
    run = canned(traced=False)
    assert read("rows_per_s", run) == pytest.approx(2000 / 0.025)
    assert read("query_peak_mib", run) == 5.0
    assert read("setup_s", run) == 4.5
    assert read("query_p90_ms", run) == pytest.approx(
        statistics.quantiles([10.0, 10.0], n=10, method="inclusive")[8])
    for name in ("dispatch_ms", "poll_wait_ms", "grow_ms", "grows", "table_mib",
                 "query_kernels_roofline", "device_idle_pct", "device_ms"):
        assert read(name, run) is None, name


def test_per_layer_readers():
    run = canned()
    assert read("dispatch_ms", run) == pytest.approx((2.0 + 1.0) / 2)
    # the poll inside finalize is finalize's
    assert read("poll_wait_ms", run) == pytest.approx((1.0 + 2.0 + 4.0) / 2)
    assert read("grow_ms", run) == pytest.approx(0.5 / 2)
    assert read("grows", run) == 2.0
    assert read("table_mib", run) == 2.0
    # busy 2000 → 8000 and 16000 → 20000 and 25000 → 26000 of 25000 µs
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 11000 / 25000))
    # the same busy time over the two queries completed
    assert read("device_ms", run) == pytest.approx(11.0 / 2)
    device_us = 4000 + 3000 + 4000 + 2000
    least_us = 2 * 1e9 / 1e13 * 1e6
    assert read("query_kernels_roofline", run) == pytest.approx(100 * least_us / device_us)


def test_idle_gaps_by_host_span():
    run = canned()
    gaps = timeline.idle_gaps(run.device_ops, run.window_start_us, run.window_end_us)
    assert gaps == [(1000.0, 2000), (8000, 16000), (20000, 25000)]
    idle = timeline.idle_by_host(gaps, run.spans)
    # innermost spans over the gaps: consume_async 1000 + 1000; query 1000
    # + 1000 (between its children); finalize 500 + 500 + 4000 around the
    # poll it holds; that poll 1000; no span 3000 + 1000
    assert idle == pytest.approx({"consume_async": 2000, "query": 2000, "finalize": 5000,
                                  "poll": 1000, "between_queries": 4000})
    ranked = timeline.top(idle, 2)
    assert ranked[0][0] == "finalize" and ranked[0][1] == pytest.approx(0.005)


def test_innermost_segments_nest():
    segs = timeline.innermost([Span("a", 0, 10), Span("b", 2, 4), Span("c", 6, 8)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "a"), (6, 8, "c"), (8, 10, "a")]


def test_query_bytes_count():
    # 10 rows of a 4-B key and 4-B and 8-B values in; 3 groups of a key and 4 aggregates out
    assert roofline.query_bytes(10, 16, 3, 4) == 10 * 16 + 4 * 15
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None
