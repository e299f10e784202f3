"""Observability of repro_torch (``obs/``, and its threading through the
engine and the server) against the JAX package, on the CPU
(``device="cpu"``).

Mirrors tests/test_obs.py from its counter tests on: the device event
counters are exact under a forced grow (committed-row semantics) and equal
the JAX operator's, deterministic and result-neutral; masked rows are
counted apart; the spill executor's registry series equal its own
counters; the probe histogram is published; span tracing emits valid,
nested Chrome-trace JSON; ``QueryHandle.profile()`` under a two-tenant
DRR run reports what the reference's does; and the disabled mode emits
nothing."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import AggSpec as JAggSpec
from repro.engine import GroupByPlan as JPlan
from repro.engine import Table as JTable
from repro.engine.groupby import GroupByOperator as JOperator
from repro.obs import metrics as jmet
from repro.obs import trace as jtrace
from repro_torch.engine import (
    AggSpec,
    ExecutionPolicy,
    GroupByOperator,
    GroupByPlan,
    SaturationPolicy,
    Table,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

N = 2048
CHUNK = 512
CPU = ExecutionPolicy(device="cpu")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Obs state is process-global in both packages: every test starts and
    ends dark."""
    for m, t in ((obs_metrics, obs_trace), (jmet, jtrace)):
        m.disable()
        m.clear()
        t.disable()
        t.clear()
    yield
    for m, t in ((obs_metrics, obs_trace), (jmet, jtrace)):
        m.disable()
        m.clear()
        t.disable()
        t.clear()


def _t(keys):
    return torch.from_numpy(np.asarray(keys, dtype=np.uint32).view(np.int32))


def chunk_tables(keys, vals=None, chunk=CHUNK):
    for i in range(0, len(keys), chunk):
        cols = {"k": _t(keys[i:i + chunk])}
        if vals is not None:
            cols["v"] = torch.from_numpy(vals[i:i + chunk])
        yield Table(cols)


def table_map(out) -> dict:
    """A result table of either package → {key: count}."""
    n = int(np.asarray(out["__num_groups__"])[0])
    return dict(zip(np.asarray(out["key"])[:n].astype(np.int64).tolist(),
                    np.asarray(out["count(*)"])[:n].astype(np.float64).tolist()))


# -- device-side counter exactness ------------------------------------------------


def _grow_ops(**kw):
    """The reference test's operator in both packages (the port's on the
    CPU): a bound of 16 that 256 unique keys must grow."""
    kw.setdefault("collect_events", True)
    common = dict(key_columns=["k"], max_groups=16, morsel_rows=64, raw_keys=True,
                  check_overflow=True, grow_bound=True, **kw)
    return (GroupByOperator(aggs=[AggSpec("count")], device="cpu", **common),
            JOperator(aggs=[JAggSpec("count")], **common))


def _feed(op, jop, keys, rows=64):
    for i in range(0, len(keys), rows):
        op.consume(Table({"k": _t(keys[i:i + rows])}))
        jop.consume(JTable({"k": jnp.asarray(keys[i:i + rows])}))


def test_event_counts_exact_under_forced_grow():
    keys = np.random.default_rng(0).permutation(256).astype(np.uint32)
    op, jop = _grow_ops()
    _feed(op, jop, keys)
    ev = op.event_counts()
    assert ev["rows"] == 256 and ev["rows_masked"] == 0
    assert ev["morsels"] == 4 and ev["num_groups"] == 256
    assert sum(ev["probe_hist"]) == 256
    assert ev["probe_steps"] >= 256
    assert ev["pauses"] >= 1 and ev["bound_grows"] >= 1 and ev["migrations"] >= 1
    assert ev["table_capacity"] >= 256
    assert 0.0 < ev["table_load_factor"] <= 1.0
    assert ev == jop.event_counts()


def test_event_counts_deterministic_and_result_identical():
    keys = np.random.default_rng(1).permutation(256).astype(np.uint32)

    def run(collect):
        op, jop = _grow_ops(collect_events=collect)
        _feed(op, jop, keys)
        return op, jop

    (a, ja), (b, _), (plain, jplain) = run(True), run(True), run(False)
    assert a.event_counts() == b.event_counts() == ja.event_counts()
    out_a, out_plain = a.finalize(), plain.finalize()
    for col in out_a.columns:
        assert torch.equal(out_a[col], out_plain[col])
    assert plain.event_counts()["rows"] == 0
    assert plain.event_counts() == jplain.event_counts()


def test_masked_rows_counted():
    common = dict(key_columns=["k"], max_groups=64, morsel_rows=64, raw_keys=True,
                  collect_events=True)
    op = GroupByOperator(aggs=[AggSpec("count")], device="cpu", **common)
    jop = JOperator(aggs=[JAggSpec("count")], **common)
    op.consume(Table({"k": torch.arange(100, dtype=torch.int32)}))
    jop.consume(JTable({"k": jnp.arange(100, dtype=jnp.uint32)}))
    ev = op.event_counts()
    assert ev["rows"] == 100 and ev["rows_masked"] == 28 and ev["morsels"] == 2
    assert ev == jop.event_counts()


# -- registry + spill parity ------------------------------------------------------


def test_spill_registry_parity():
    obs_metrics.enable()
    keys = np.random.default_rng(7).integers(0, 1000, size=N).astype(np.uint32)
    plan = GroupByPlan(
        keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
        max_groups=64, saturation=SaturationPolicy.SPILL, raw_keys=True,
        execution=ExecutionPolicy(morsel_rows=256, spill_partitions=8, device="cpu"),
    )
    handle = plan.stream(chunk_tables(keys))
    handle.result()
    stats = handle.stats()
    handle.stats()  # idempotent: deltas, not re-adds
    snap = obs_metrics.snapshot()
    lbl = "strategy=spill"
    assert snap["counters"]["spill.spilled_rows"][lbl] == stats["spilled_rows"]
    assert snap["counters"]["spill.spilled_bytes"][lbl] == stats["spilled_bytes"]
    assert snap["counters"]["spill.readmitted_rows"][lbl] == stats["readmitted_rows"]
    assert stats["spilled_rows"] > 0
    assert stats["spill"]["spilled_rows"] == stats["spilled_rows"]
    assert stats["spill"]["residency_budget"] == stats["residency_budget"]
    assert stats["device"]["migrations"] == 0
    assert snap["counters"]["groupby.rows"][lbl] > 0


def test_probe_histogram_published():
    obs_metrics.enable()
    jmet.enable()
    keys = np.random.default_rng(3).integers(0, 200, N).astype(np.uint32)
    plan = GroupByPlan(keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
                       max_groups=512, raw_keys=True, execution=CPU)
    handle = plan.stream(chunk_tables(keys))
    handle.result()
    stats = handle.stats()
    snap = obs_metrics.snapshot()
    hist = snap["histograms"]["groupby.probe_len"]["strategy=concurrent"]
    assert sum(hist["counts"]) == N
    assert hist["counts"] == stats["device"]["probe_hist"]
    assert snap["gauges"]["groupby.table_load_factor"]["strategy=concurrent"] > 0
    jplan = JPlan(keys=("k",), aggs=(JAggSpec("count"),), strategy="concurrent",
                  max_groups=512, raw_keys=True)
    jh = jplan.stream([JTable({"k": jnp.asarray(keys[i:i + CHUNK])})
                       for i in range(0, N, CHUNK)])
    jh.result()
    jh.stats()
    jhist = jmet.snapshot()["histograms"]["groupby.probe_len"]["strategy=concurrent"]
    assert hist == jhist


# -- tracing ------------------------------------------------------------------------


def test_trace_valid_chrome_json_with_nested_spans():
    obs_trace.enable()
    keys = np.random.default_rng(5).permutation(N).astype(np.uint32)
    plan = GroupByPlan(  # a tiny bound forces pause → migrate → resume spans
        keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
        max_groups=32, saturation=SaturationPolicy.GROW, raw_keys=True,
        execution=ExecutionPolicy(morsel_rows=256, device="cpu"),
    )
    plan.stream(chunk_tables(keys)).result()
    payload = json.loads(json.dumps(obs_trace.to_json()))
    events = payload["traceEvents"]
    assert payload["displayTimeUnit"] == "ms"
    for e in events:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0
    names = {e["name"] for e in events}
    assert {"pump", "consume_async", "poll", "pause_migrate_resume", "finalize"} <= names
    tops = [e for e in events if e["name"] in ("pump", "finalize")]
    for e in events:
        if e["name"] in ("consume_async", "poll", "pause_migrate_resume"):
            assert any(t["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= t["ts"] + t["dur"]
                       for t in tops), e["name"]


# -- per-query profiles (2-tenant DRR) ------------------------------------------------


def test_query_profile_two_tenant_drr():
    from repro.serve.query_server import AggregationServer as JServer
    from repro_torch.serve.query_server import AggregationServer

    def source(seed, as_table, chunks=4):
        r = np.random.default_rng(seed)
        for _ in range(chunks):
            yield as_table(r.integers(0, 100, CHUNK).astype(np.uint32))

    plans = (
        (AggregationServer, lambda k: Table({"k": _t(k)}),
         GroupByPlan(keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
                     max_groups=128, raw_keys=True, execution=CPU)),
        (JServer, lambda k: JTable({"k": jnp.asarray(k)}),
         JPlan(keys=("k",), aggs=(JAggSpec("count"),), strategy="concurrent",
               max_groups=128, raw_keys=True)),
    )
    profiles = []
    for server_cls, as_table, plan in plans:
        obs_trace.enable()
        server = server_cls(slots=2, batch_queries=False)
        server.set_budget("alice", weight=2)
        server.set_budget("bob", weight=1)
        ha = server.submit(plan, source(1, as_table), tenant="alice")
        hb = server.submit(plan, source(2, as_table), tenant="bob")
        hc = server.submit(plan, source(3, as_table), tenant="bob")  # queues
        server.run_until_idle()
        for h, tenant in ((ha, "alice"), (hb, "bob"), (hc, "bob")):
            p = h.profile()
            assert p["tenant"] == tenant and p["status"] == "done"
            assert p["chunks"] == 4 and p["rows"] == 4 * CHUNK
            assert p["quanta"] >= p["chunks"]
            assert p["wall_time_s"] > 0 and p["queue_wait_s"] >= 0
            assert p["device_table_bytes"] > 0
            assert p["stats"]["schema"] == "repro.obs/v1"
        assert hc.profile()["queue_wait_s"] > 0
        ts = server.tenant_stats("bob")
        assert ts["quanta"] == ts["steps"] > 0
        assert ts["queue_depth"] == 0 and ts["queue_wait_s"] > 0
        profiles.append([(h.profile()["quanta"], h.profile()["device_table_bytes"],
                          table_map(h.result())) for h in (ha, hb, hc)])
    assert profiles[0] == profiles[1]  # same quanta, table bytes and results
    quanta = [e for e in obs_trace.events() if e["name"] == "quantum"]
    assert len(quanta) == sum(q for q, _, _ in profiles[0])


# -- disabled mode: no emissions, stats compat intact --------------------------------


def test_disabled_mode_emits_nothing():
    assert not obs_metrics.enabled() and not obs_trace.enabled()
    keys = np.random.default_rng(9).integers(0, 100, N).astype(np.uint32)
    plan = GroupByPlan(keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
                       max_groups=256, raw_keys=True, execution=CPU)
    handle = plan.stream(chunk_tables(keys))
    out = handle.result()
    stats = handle.stats()
    snap = obs_metrics.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {} and snap["histograms"] == {}
    assert obs_trace.events() == []
    for key in ("chunks_consumed", "rows_consumed", "peak_buffered_chunks",
                "peak_retained_bytes"):
        assert key in stats, key
    assert stats["chunks_consumed"] == N // CHUNK and stats["rows_consumed"] == N
    assert stats["schema"] == "repro.obs/v1"
    assert "rows" not in stats["device"]
    assert table_map(out)


def test_noop_objects_are_shared_and_inert():
    c = obs_metrics.counter("x.y", strategy="a")
    g = obs_metrics.gauge("x.z")
    h = obs_metrics.histogram("x.h", obs_metrics.PROBE_HIST_EDGES)
    assert c is g is h is obs_metrics.NOOP
    c.add(5)
    g.set(3)
    h.observe(1)
    assert obs_metrics.snapshot()["counters"] == {}
    with obs_trace.span("nothing", k=1):
        pass
    assert obs_trace.events() == []
