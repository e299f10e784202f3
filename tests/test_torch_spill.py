"""Out-of-core spill of repro_torch (``saturation="spill"``,
``engine/spill.py``) on the CPU, mirroring tests/test_spill.py against the
JAX spill plans and the oracle: the exactness matrix, multi-aggregate
with mean, a mid-stream snapshot taken twice, forced tiny residency, zero
spill equal to the concurrent scan, auto + spill resolving, rejected
plans, the memory-telemetry surface and the server budget (a spilling
query honours it as device residency, a plain one raises); plus
``partition_of`` bit for bit on keys of 2^31 and above, and the spill
spans.

Values are integer-valued float32, so any summation order is exact and
SUM compares bit for bit, as in the reference's tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import groupby_oracle as jax_oracle
from repro.engine import plan_api as japi
from repro.engine import spill as jsp
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine import spill as tsp
from repro_torch.engine.columns import Table
from repro_torch.obs import trace as ttrace

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

N = 4096
CHUNK = 512
BUDGET = 64  # device residency budget, far below every matrix cardinality


def gen_keys(dist: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        keys = rng.integers(0, 1000, size=N).astype(np.uint32)
    elif dist == "zipf":
        keys = (rng.zipf(1.3, size=N) % (N // 2)).astype(np.uint32)
    else:
        keys = rng.permutation(N).astype(np.uint32)
    keys[::7] += np.uint32(1 << 31)  # keys past 2^31 route as uint32 values
    return keys


def int_vals(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed + 100).integers(0, 100, size=n).astype(np.float32)


def torch_chunks(keys, vals=None, chunk=CHUNK):
    out = []
    for i in range(0, len(keys), chunk):
        cols = {"k": torch.from_numpy(keys[i:i + chunk].view(np.int32))}
        if vals is not None:
            cols["v"] = torch.from_numpy(vals[i:i + chunk])
        out.append(Table(cols))
    return out


def jax_chunks(keys, vals=None, chunk=CHUNK):
    out = []
    for i in range(0, len(keys), chunk):
        cols = {"k": jnp.asarray(keys[i:i + chunk])}
        if vals is not None:
            cols["v"] = jnp.asarray(vals[i:i + chunk])
        out.append(japi.Table(cols))
    return out


def table_map(out, name: str) -> dict:
    n = int(np.asarray(out["__num_groups__"])[0])
    keys = np.asarray(out["key"])[:n].astype(np.int64) & 0xFFFFFFFF
    return dict(zip(keys.tolist(), np.asarray(out[name])[:n].astype(np.float64).tolist()))


def oracle_map(keys, vals, kind="sum"):
    ref = jax_oracle(jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
                     kind=kind, max_groups=N)
    n = int(ref.num_groups)
    return dict(zip(np.asarray(ref.keys)[:n].astype(np.int64).tolist(),
                    np.asarray(ref.values)[:n].astype(np.float64).tolist()))


def plans(budget=BUDGET, partitions=8, aggs=(("count",), ("sum", "v")), **kw):
    """The same spill plan in both packages: (port, JAX)."""
    out = []
    for api in (tapi, japi):
        ex = dict(morsel_rows=256, spill_partitions=partitions)
        if api is tapi:
            ex["device"] = "cpu"
        out.append(api.GroupByPlan(
            keys=("k",), aggs=tuple(api.AggSpec(*a) for a in aggs),
            strategy=kw.get("strategy", "concurrent"),
            max_groups=kw.get("max_groups", budget), saturation="spill", raw_keys=True,
            execution=api.ExecutionPolicy(**ex)))
    return out


# -- exactness matrix -------------------------------------------------------------


@pytest.mark.parametrize("dist", ["uniform", "zipf", "unique"])
def test_spill_matches_oracle_matrix(dist):
    """10–60× the residency budget in true cardinality: COUNT and SUM stay
    exact against the oracle and equal the JAX spill plan's, and both
    packages spill the same rows."""
    keys, vals = gen_keys(dist, 1), int_vals(1)
    tplan, jplan = plans()
    handle = tplan.stream(torch_chunks(keys, vals))
    out = handle.result()
    jhandle = jplan.stream(jax_chunks(keys, vals))
    jout = jhandle.result()
    for col, kind in (("count(*)", "count"), ("sum(v)", "sum")):
        want = oracle_map(keys, None if kind == "count" else vals, kind=kind)
        assert table_map(out, col) == want == table_map(jout, col)
    stats, jstats = handle.stats(), jhandle.stats()
    assert stats["spilled_rows"] > 0
    assert stats["device_groups"] <= BUDGET
    for k in ("spilled_rows", "spilled_bytes", "partition_rows", "device_groups",
              "resident_partitions", "spill_events"):
        assert stats[k] == jstats[k], k
    assert isinstance(handle.executor, tsp.SpillExecutor)


def test_spill_multi_agg_and_mean():
    keys, vals = gen_keys("zipf", 2), int_vals(2)
    tplan, _ = plans(aggs=(("count",), ("mean", "v"), ("min", "v"), ("max", "v")))
    out = tplan.collect(torch_chunks(keys, vals))
    counts = oracle_map(keys, None, kind="count")
    sums = oracle_map(keys, vals, kind="sum")
    assert table_map(out, "count(*)") == counts
    assert table_map(out, "min(v)") == oracle_map(keys, vals, kind="min")
    assert table_map(out, "max(v)") == oracle_map(keys, vals, kind="max")
    assert table_map(out, "mean(v)") == pytest.approx(
        {k: sums[k] / counts[k] for k in sums}, rel=1e-6)


# -- streaming composition ----------------------------------------------------------


def test_spill_snapshot_midstream():
    """snapshot() works mid-spill: taken twice it reads the same, it equals
    the oracle over the chunks consumed so far, and the stream keeps
    spilling afterwards."""
    keys, vals = gen_keys("uniform", 3), int_vals(3)
    tplan, _ = plans()
    handle = tplan.stream(torch_chunks(keys, vals))
    handle.pump(4)
    assert handle.stats()["spilled_rows"] > 0  # already spilling mid-stream
    snap1, snap2 = handle.snapshot(), handle.snapshot()
    assert table_map(snap1, "sum(v)") == table_map(snap2, "sum(v)")
    assert table_map(snap1, "count(*)") == table_map(snap2, "count(*)")
    half = 4 * CHUNK
    assert table_map(snap1, "count(*)") == oracle_map(keys[:half], None, kind="count")
    assert table_map(snap1, "sum(v)") == oracle_map(keys[:half], vals[:half], kind="sum")
    spilled = handle.stats()["spilled_rows"]
    out = handle.result()
    assert handle.stats()["spilled_rows"] > spilled
    assert table_map(out, "sum(v)") == oracle_map(keys, vals, kind="sum")


def test_spill_forced_tiny_residency():
    """A residency budget of 16 against ~1000 keys: nearly everything
    spills, totals stay exact."""
    keys, vals = gen_keys("uniform", 4), int_vals(4)
    tplan, _ = plans(budget=16)
    handle = tplan.stream(torch_chunks(keys, vals))
    out = handle.result()
    assert table_map(out, "count(*)") == oracle_map(keys, None, kind="count")
    assert table_map(out, "sum(v)") == oracle_map(keys, vals, kind="sum")
    stats = handle.stats()
    assert stats["device_groups"] <= 16
    assert stats["spilled_rows"] > N // 2


def test_spill_zero_spill_matches_concurrent():
    """Cardinality within the budget: nothing spills and the result is
    identical to the plain concurrent scan (same operator, same order)."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, size=N).astype(np.uint32)
    vals = int_vals(5)
    tplan, _ = plans(budget=256)
    handle = tplan.stream(torch_chunks(keys, vals))
    out = handle.result()
    ref = tplan.with_(saturation="raise").collect(torch_chunks(keys, vals))
    assert torch.equal(out["key"], ref["key"])
    assert torch.equal(out["sum(v)"], ref["sum(v)"])
    stats = handle.stats()
    assert stats["spilled_rows"] == 0 and stats["spilled_bytes"] == 0


def test_spill_auto_strategy_resolves():
    """strategy='auto' + saturation='spill' with no bound: the resolver
    lands on the concurrent hash pipeline and the estimated bound becomes
    the residency budget; the results stay exact."""
    keys, vals = gen_keys("zipf", 6), int_vals(6)
    tplan, jplan = plans(aggs=(("sum", "v"),), strategy="auto", max_groups=None)
    handle = tplan.stream(torch_chunks(keys, vals))
    out = handle.result()
    assert isinstance(handle.executor, tex._ResolvingExecutor)
    assert isinstance(handle.executor._inner, tsp.SpillExecutor)
    assert handle.executor._resolved.strategy == "concurrent"
    assert table_map(out, "sum(v)") == oracle_map(keys, vals, kind="sum")
    assert table_map(out, "sum(v)") == table_map(jplan.collect(jax_chunks(keys, vals)), "sum(v)")


def test_spill_rejects_incompatible_plans():
    from repro.engine import make_executor as jmake

    tplan, jplan = plans()
    for plan, make in ((tplan, tex.make_executor), (jplan, jmake)):
        with pytest.raises(ValueError, match="does not support spilling"):
            make(plan.with_(strategy="partitioned"))
        with pytest.raises(ValueError, match="ticketing='hash'"):
            make(plan.with_(execution=type(plan.execution)(ticketing="sort")))


# -- telemetry surface ----------------------------------------------------------------


def test_stream_stats_dict():
    keys, vals = gen_keys("uniform", 7), int_vals(7)
    tplan, _ = plans()
    handle = tplan.stream(torch_chunks(keys, vals))
    ttrace.clear()
    ttrace.enable()
    try:
        handle.result()
    finally:
        ttrace.disable()
    names = {e["name"] for e in ttrace.events()}
    assert {"spill_flush_wait", "spill_partition_replay"} <= names
    stats = handle.stats()
    for field in ("chunks_consumed", "rows_consumed", "peak_buffered_chunks",
                  "peak_retained_bytes", "spilled_rows", "spilled_bytes",
                  "spilled_partitions", "partition_rows", "partition_bytes",
                  "residency_budget", "residency_bytes",
                  "peak_device_table_bytes", "device_groups"):
        assert field in stats, field
    assert stats["chunks_consumed"] == N // CHUNK
    assert stats["rows_consumed"] == N
    assert stats["peak_buffered_chunks"] == 0      # spill retains no chunks
    assert stats["peak_retained_bytes"] == stats["spilled_bytes"] > 0
    assert sum(stats["partition_rows"]) == stats["spilled_rows"]
    assert stats["residency_bytes"] > 0
    spill = stats["spill"]
    assert spill["readmission_passes"] == spill["spilled_partitions"] > 0
    assert spill["peak_device_table_bytes"] >= spill["residency_bytes"]
    # a non-spilling executor reports the base dict through the same seam
    base = tplan.with_(saturation="raise", max_groups=N).stream(torch_chunks(keys, vals))
    base.result()
    bstats = base.stats()
    assert bstats["peak_buffered_chunks"] == 0
    assert bstats["peak_retained_bytes"] == 0


# -- server composition: budgets spill instead of raising ---------------------------


def test_server_budget_spills_instead_of_raising():
    """A tenant budget of 48 groups: the spilling query keeps it as its
    device residency and completes exactly (its map equal to the oracle's
    and to the JAX server's), the plain query hits the hard RAISE
    contract, in both packages."""
    from repro.engine.groupby import GroupByOverflowError as JOverflow
    from repro.serve.query_server import AggregationServer as JServer
    from repro_torch.engine.groupby import GroupByOverflowError
    from repro_torch.serve.query_server import AggregationServer

    keys, vals = gen_keys("uniform", 0), int_vals(0)
    want = oracle_map(keys, vals, kind="sum")
    maps = []
    for server_cls, api, chunks, overflow, ex in (
            (AggregationServer, tapi, torch_chunks, GroupByOverflowError, {"device": "cpu"}),
            (JServer, japi, jax_chunks, JOverflow, {})):
        server = server_cls(slots=4)
        server.set_budget("alice", max_groups=48)
        spilling = api.GroupByPlan(
            keys=("k",), aggs=(api.AggSpec("sum", "v"),), saturation="spill",
            raw_keys=True,
            execution=api.ExecutionPolicy(morsel_rows=256, spill_partitions=8, **ex))
        capped = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("sum", "v"),),
                                 raw_keys=True, execution=api.ExecutionPolicy(**ex))
        h_spill = server.submit(spilling, chunks(keys, vals), tenant="alice")
        h_raise = server.submit(capped, chunks(keys, vals), tenant="alice")
        out = h_spill.result()
        maps.append(table_map(out, "sum(v)"))
        stats = h_spill.stats()
        assert stats["device_groups"] <= 48 and stats["spilled_rows"] > 0
        with pytest.raises(overflow):
            h_raise.result()
    assert maps[0] == want == maps[1]


def test_partition_of_bit_exact_past_2_31():
    keys = np.random.default_rng(8).integers(0, 2**32, size=1 << 14, dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:4] = [0, 1 << 31, 0xFFFFFFFE, 0xFFFFFFFF]
    for parts in (8, 32, 7):
        want = jsp.partition_of(keys, parts)
        assert np.array_equal(tsp.partition_of(keys, parts), want)
        assert np.array_equal(tsp.partition_of(keys.view(np.int32), parts), want)


def test_spill_manager_blocks_are_partition_major():
    m = tsp.SpillManager(4, ("v",))
    keys = torch.tensor([5, 6, 7, -2], dtype=torch.int32)
    pids = np.array([0, 0, 2, 3])
    m.spill(keys, pids, {"v": torch.tensor([1.0, 2.0, 3.0, 4.0])})
    assert m.partitions() == [0, 2, 3]
    assert m.partition_rows == [2, 0, 1, 1] and m.spilled_bytes == 32
    assert m.partition_keys(3).tolist() == [0xFFFFFFFE]
    (chunk,) = list(m.readmit(0).chunks())
    assert chunk["__key__"].tolist() == [5, 6] and chunk["v"].tolist() == [1.0, 2.0]
    assert m.readmitted_rows == 2
