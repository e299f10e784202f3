"""The default plan of repro_torch vs the JAX package, on the CPU
(``device="cpu"``: the plain versions of the kernels): the planner
(``core/adaptive.py``), ``resolve_plan_stats`` and the CUDA route rule,
``detect_heavy_hitters``, the hybrid register fold, and whole streams
through ``_ResolvingExecutor``, ``_HybridExecutor`` and ``_DirectExecutor``.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: statistics, plans, heavy keys, group counts, key sets, COUNT,
MIN and MAX exact; SUM within 1e-5 relative (the port folds a chunk's rows
in one call, the reference a morsel at a time, so float adds may run in
another order); streams compared as key → value maps."""
import dataclasses
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import groupby_oracle
from repro.core import hybrid as jhy
from repro.engine import executors as jex
from repro.engine import plan_api as japi
from repro.engine.columns import Table as JTable
from repro_torch.core import adaptive as tad
from repro_torch.core import hybrid as thy
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.columns import Table as TTable
from repro_torch.kernels import hybrid_registers as thr

jgb = importlib.import_module("repro.engine.groupby")
tgb = importlib.import_module("repro_torch.engine.groupby")

SUM_RTOL = 1e-5
EMPTY = np.uint32(0xFFFFFFFF)


def _tt(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _keys(case, n, rng):
    """uint32 key columns; the ``high_bits`` cases hold keys >= 2^31 (every
    hash-combined key column does)."""
    if case == "uniform":
        return rng.integers(0, 300, size=n).astype(np.uint32)
    if case == "zipf":
        return (rng.zipf(1.3, size=n) % 5000).astype(np.uint32)
    if case == "unique":
        return rng.permutation(n).astype(np.uint32)
    if case == "heavy_unique":
        k = rng.permutation(n).astype(np.uint32)
        k[rng.random(n) < 1 / 3] = 7
        return k
    if case == "high_bits":
        k = rng.integers(0, 40, size=n).astype(np.uint32) * np.uint32(0x9E3779B1)
        k[rng.random(n) < 0.3] = np.uint32(0xF0000001)
        k[:3] = EMPTY
        return k
    assert case == "ties_high_bits"  # equal counts, order set by the uint32 sort
    return np.repeat(np.array([0x80000005, 5, 0xFFFFFFF0, 0x7FFFFFFF], np.uint32), n // 4)


CASES = ("uniform", "zipf", "unique", "heavy_unique", "high_bits", "ties_high_bits")


def _map(out, col):
    n = int(np.asarray(out["__num_groups__"])[0])
    return dict(zip(np.asarray(out["key"])[:n].astype(np.int64).tolist(),
                    np.asarray(out[col])[:n].tolist()))


def _assert_maps_close(got, want, rtol=SUM_RTOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= rtol * max(1.0, abs(w)), k


# -- the planner --------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("domain", [None, 300])
def test_sample_stats_matches_reference(case, domain):
    keys = _keys(case, 6000, np.random.default_rng(CASES.index(case)))
    want = jad.sample_stats(jnp.asarray(keys), domain=domain)
    got = tad.sample_stats(_tt(keys), domain=domain)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    got32 = tad.sample_stats(torch.from_numpy(keys.view(np.int32)), domain=domain)
    assert got32 == got  # int32 bit patterns and uint32 values agree


def test_choose_plan_matches_reference_with_and_without_vmem_budget():
    stats = [
        jad.WorkloadStats(n_rows=1_000_000, est_groups=1000, est_top_freq=0.0),
        jad.WorkloadStats(n_rows=10_000_000, est_groups=500_000, est_top_freq=0.0),
        jad.WorkloadStats(n_rows=1_000_000, est_groups=30_000, est_top_freq=0.0),
        jad.WorkloadStats(n_rows=100_000, est_groups=90_000, est_top_freq=0.3),
        jad.WorkloadStats(n_rows=100_000, est_groups=90_000, est_top_freq=0.1),
        jad.WorkloadStats(n_rows=5000, est_groups=700, est_top_freq=0.5, key_domain=1000),
    ]
    one = jad.fused_table_bytes(2 * 30_000, 1)
    assert tad.fused_table_bytes(2 * 30_000, 1) == one
    assert tad.kernel_table_budget() == 0 and tad.kernel_table_budget("cuda") == 0
    for js in stats:
        ts = tad.WorkloadStats(*dataclasses.astuple(js))
        for budget in (None, 1024, 4 << 20, one, one + 8 * 30_000 + 1):
            for acc in (1, 4):
                want = jad.choose_plan(js, vmem_budget=budget, num_accumulators=acc)
                got = tad.choose_plan(ts, vmem_budget=budget, num_accumulators=acc)
                assert dataclasses.astuple(got) == dataclasses.astuple(want), (js, budget, acc)
    # the reference's own fused-fit cases (tests/test_kernels.py)
    mid = tad.WorkloadStats(n_rows=1_000_000, est_groups=30_000, est_top_freq=0.0)
    assert tad.choose_plan(mid, vmem_budget=one + 8 * 30_000 + 1).kernel == "fused"
    assert tad.choose_plan(mid, vmem_budget=one, num_accumulators=4).kernel is None


@pytest.mark.parametrize("seq", ["drift_to_heavy", "high_bits", "unique"])
def test_running_stats_match_reference_chunk_by_chunk(seq):
    rng = np.random.default_rng(5)
    js, ts = jad.RunningStats(num_counters=8, sample=1024), tad.RunningStats(
        num_counters=8, sample=1024)
    for i in range(6):
        if seq == "drift_to_heavy":
            k = rng.integers(0, 20000, size=3000).astype(np.uint32)
            if i >= 2:
                k[rng.random(3000) < 0.5] = 7
        elif seq == "high_bits":
            k = _keys("high_bits", 3000, rng)
        else:
            k = rng.permutation(1 << 20)[:3000].astype(np.uint32)
        want = js.update(jnp.asarray(k))
        got = ts.update(_tt(k))
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert ts.heavy_keys == js.heavy_keys
        np.testing.assert_array_equal(ts.heavy_array(3), js.heavy_array(3))


def _plans(**kw):
    ex = kw.pop("execution", {})
    aggs = kw.pop("aggs", (("sum", "v"), ("count", None)))
    jp = japi.GroupByPlan(keys=("k",), aggs=tuple(japi.AggSpec(*a) for a in aggs),
                          execution=japi.ExecutionPolicy(**ex), **kw)
    tp = tapi.GroupByPlan(keys=("k",), aggs=tuple(tapi.AggSpec(*a) for a in aggs),
                          execution=tapi.ExecutionPolicy(device="cpu", **ex), **kw)
    return jp, tp


RESOLVE = {
    "auto_low": dict(strategy="auto", raw_keys=True),
    "auto_update": dict(strategy="auto", execution=dict(update="serialized")),
    "auto_spill": dict(strategy="auto", saturation="spill"),
    "auto_direct": dict(strategy="auto", raw_keys=True, execution=dict(key_domain=400)),
    "concurrent_none": dict(strategy="concurrent"),
    "hybrid_none": dict(strategy="hybrid", raw_keys=True),
    "auto_bound": dict(strategy="auto", max_groups=777),
}
STATS = (
    (100_000, 300, 0.01), (100_000, 90_000, 0.01), (100_000, 90_000, 0.3),
    (100_000, 20_000, 0.3), (4096, 4096, 0.0), (10, 10, 0.5),
)


@pytest.mark.parametrize("case", sorted(RESOLVE))
def test_resolve_plan_stats_matches_reference_on_the_cpu(case):
    jp, tp = _plans(**RESOLVE[case])
    for n, g, top in STATS:
        dom = jp.execution.key_domain
        want = jex.resolve_plan_stats(jex.normalize_kernel(jp),
                                      jad.WorkloadStats(n, g, top, dom))
        got = tex.resolve_plan_stats(tex.normalize_kernel(tp),
                                     tad.WorkloadStats(n, g, top, dom))
        assert (got.strategy, got.max_groups, got.saturation, got.raw_keys) == (
            want.strategy, want.max_groups, want.saturation, want.raw_keys)
        for f in ("update", "kernel", "ticketing", "key_domain", "morsel_rows",
                  "num_registers", "heavy_keys"):
            assert getattr(got.execution, f) == getattr(want.execution, f), (f, n, g, top)
        assert got.execution.device == "cpu"


def test_resolver_adopts_fused_under_budget(monkeypatch):
    """As the reference's test of the same name: a forced fused budget
    makes ``strategy="auto"`` resolve ``kernel="fused"`` (on the CPU)."""
    monkeypatch.setattr(tad, "kernel_table_budget", lambda *a: 4 << 20)
    keys = np.random.default_rng(2).integers(0, 200, size=4096).astype(np.uint32)
    stats = tad.sample_stats(_tt(keys))
    plan = tapi.GroupByPlan(keys=("__key__",), aggs=(tapi.AggSpec("count"),), raw_keys=True,
                            execution=tapi.ExecutionPolicy(device="cpu"))
    assert tex.resolve_plan_stats(tex.normalize_kernel(plan), stats).execution.kernel == "fused"


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", "cpu"])
@pytest.mark.parametrize("caller", [{}, dict(update="scatter"), dict(update="onehot"),
                                    dict(kernel="off"), dict(kernel="fused"),
                                    dict(use_kernel=True)])
def test_cuda_route_rule(device, caller):
    """Pure logic, no card: on a CUDA device a caller who left ``kernel``
    None and ``update`` None / "scatter" gets scan_body + scatter on every
    resolved route (hash, direct, hybrid); everything else keeps the
    reference's resolution."""
    on_cuda = device != "cpu"
    free = "kernel" not in caller and "use_kernel" not in caller and \
        caller.get("update") in (None, "scatter")
    for strategy, stats, key_domain in (
            ("auto", tad.WorkloadStats(100_000, 300, 0.01), None),       # hash onehot
            ("auto", tad.WorkloadStats(100_000, 90_000, 0.01), None),    # hash sort_segment
            ("auto", tad.WorkloadStats(100_000, 20_000, 0.3), None),     # hybrid
            ("auto", tad.WorkloadStats(100_000, 300, 0.0, 400), 400),    # direct
            ("concurrent", tad.WorkloadStats(100_000, 300, 0.01), None)):
        plan = tapi.GroupByPlan(
            keys=("k",), aggs=(tapi.AggSpec("count"),), strategy=strategy, raw_keys=True,
            execution=tapi.ExecutionPolicy(device=device, key_domain=key_domain, **caller))
        plan = tex.normalize_kernel(plan)
        got = tex.resolve_plan_stats(plan, stats)
        cpu = tex.resolve_plan_stats(
            dataclasses.replace(plan, execution=dataclasses.replace(plan.execution,
                                                                    device="cpu")), stats)
        if on_cuda and free:
            assert (got.execution.kernel, got.execution.update) == ("scan_body", "scatter")
            assert (got.strategy, got.max_groups, got.execution.ticketing) == (
                cpu.strategy, cpu.max_groups, cpu.execution.ticketing)
        else:
            assert dataclasses.replace(got, execution=dataclasses.replace(
                got.execution, device="cpu")) == cpu


# -- heavy hitters and the register fold -----------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("registers", [2, 8])
def test_detect_heavy_hitters_matches_reference(case, registers):
    keys = _keys(case, 12000, np.random.default_rng(40 + CASES.index(case)))
    want = jhy.detect_heavy_hitters(jnp.asarray(keys), registers)
    got = thy.detect_heavy_hitters(_tt(keys), registers)
    assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(want))
    got32 = thy.detect_heavy_hitters(torch.from_numpy(keys.view(np.int32)), registers)
    assert np.array_equal(got32, got)


@pytest.mark.parametrize("case", ["zipf", "heavy_unique", "high_bits"])
@pytest.mark.parametrize("R", [1, 8, 64])
def test_hybrid_registers_plain_matches_reference(case, R):
    """Registers exact for count / min / max, sum within 1e-5 relative,
    the same heavy mask (as the tail's EMPTY rows)."""
    rng = np.random.default_rng(7 + R)
    n, morsel = 4096, 512
    keys = _keys(case, n, rng)
    keys[rng.random(n) < 0.02] = EMPTY
    vals = rng.normal(size=n).astype(np.float32)
    vals[::53] = -0.0
    heavy = np.full(R, EMPTY, np.uint32)
    uk, cnt = np.unique(keys[keys != EMPTY], return_counts=True)
    top = uk[np.argsort(cnt)[::-1]][: max(R - 1, 1)]
    heavy[: top.size] = top
    kinds = ("count", "sum", "min", "max")
    init = {"count": 2.0, "sum": 1.5, "min": np.inf, "max": -np.inf}
    regs0 = np.stack([np.full(R, init[k], np.float32) for k in kinds])
    km = jnp.asarray(keys.reshape(-1, morsel))
    vm = jnp.asarray(vals.reshape(-1, morsel))
    ones = jnp.ones_like(vm)
    jregs, hmask = jex._hybrid_registers(
        jnp.asarray(heavy), km, (ones, vm, vm, vm), tuple(jnp.asarray(r) for r in regs0),
        kinds=kinds)
    regs = torch.from_numpy(regs0.copy())
    v = torch.from_numpy(vals)
    tail = thr.hybrid_registers(torch.from_numpy(keys.view(np.int32)),
                                torch.from_numpy(heavy.view(np.int32)), [None, v, v, v],
                                regs, kinds=kinds)
    for s, kind in enumerate(kinds):
        want = np.asarray(jregs[s])
        if kind == "sum":
            np.testing.assert_allclose(regs[s].numpy(), want, rtol=SUM_RTOL, atol=SUM_RTOL)
        else:
            np.testing.assert_array_equal(regs[s].numpy(), want)
    mask = np.asarray(hmask).reshape(-1)
    np.testing.assert_array_equal(tail.numpy() == -1, mask | (keys == EMPTY))
    np.testing.assert_array_equal(tail.numpy()[~mask], keys.view(np.int32)[~mask])


@pytest.mark.parametrize("R", [8, 256])
def test_hybrid_registers_plain_matches_reference_with_sixteen_planes(R):
    """S = 16 planes (every kind four times, each over a value column of
    its own) at R = 8 and 256: the kernel's per-warp-copy sizes.  Registers
    exact for count / min / max, sum within 1e-5 relative; the same heavy
    mask."""
    rng = np.random.default_rng(29 + R)
    n, morsel = 4096, 512
    keys = (rng.zipf(1.2, size=n) % 3000).astype(np.uint32)
    keys[rng.random(n) < 0.02] = EMPTY
    heavy = np.full(R, EMPTY, np.uint32)
    uk, cnt = np.unique(keys[keys != EMPTY], return_counts=True)
    top = uk[np.argsort(cnt)[::-1]][: R - 1]
    heavy[: top.size] = top
    kinds = ("count", "sum", "min", "max") * 4
    vals = [(rng.normal(size=n) * (1 + s)).astype(np.float32) for s in range(16)]
    init = {"count": 1.0, "sum": -0.5, "min": np.inf, "max": -np.inf}
    regs0 = np.stack([np.full(R, init[k], np.float32) for k in kinds])
    jregs, hmask = jex._hybrid_registers(
        jnp.asarray(heavy), jnp.asarray(keys.reshape(-1, morsel)),
        tuple(jnp.asarray(v.reshape(-1, morsel)) for v in vals),
        tuple(jnp.asarray(r) for r in regs0), kinds=kinds)
    regs = torch.from_numpy(regs0.copy())
    tail = thr.hybrid_registers(torch.from_numpy(keys.view(np.int32)),
                                torch.from_numpy(heavy.view(np.int32)),
                                [None if k == "count" else torch.from_numpy(v)
                                 for k, v in zip(kinds, vals)], regs, kinds=kinds)
    for s, kind in enumerate(kinds):
        want = np.asarray(jregs[s])
        if kind == "sum":
            np.testing.assert_allclose(regs[s].numpy(), want, rtol=SUM_RTOL, atol=SUM_RTOL)
        else:
            np.testing.assert_array_equal(regs[s].numpy(), want)
    mask = np.asarray(hmask).reshape(-1)
    np.testing.assert_array_equal(tail.numpy() == -1, mask | (keys == EMPTY))
    np.testing.assert_array_equal(tail.numpy()[~mask], keys.view(np.int32)[~mask])


def test_hybrid_registers_plain_gives_a_row_one_register():
    """A repeated live heavy key: its rows fold into the first register
    that holds it, as the kernel folds them (EMPTY rows into none)."""
    keys = torch.tensor([3, 3, 1, -1, 5], dtype=torch.int32)
    heavy = torch.tensor([3, 3, -1, 1], dtype=torch.int32)
    regs = torch.zeros((1, 4))
    tail = thr.hybrid_registers(keys, heavy, [None], regs, kinds=("count",))
    assert regs[0].tolist() == [2.0, 0.0, 0.0, 1.0]
    assert tail.tolist() == [-1, -1, -1, -1, 5]


def test_hybrid_registers_checks_its_arguments():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="MAX_REGISTERS"):
        thr.hybrid_registers(k, torch.zeros(thr.MAX_REGISTERS + 1, dtype=torch.int32),
                             [None], torch.zeros((1, thr.MAX_REGISTERS + 1)), kinds=("count",))
    with pytest.raises(ValueError, match="MAX_PLANES"):
        s = thr.MAX_PLANES + 1
        thr.hybrid_registers(k, k[:2], [None] * s, torch.zeros((s, 2)), kinds=("count",) * s)
    with pytest.raises(ValueError, match="value column"):
        thr.hybrid_registers(k, k[:2], [None], torch.zeros((1, 2)), kinds=("sum",))
    with pytest.raises(ValueError, match="int32"):
        thr.hybrid_registers(k.long(), k[:2], [None], torch.zeros((1, 2)), kinds=("count",))


# -- whole streams ------------------------------------------------------------------------


def _chunks(api, keys, vals=None, chunk=512):
    mk = (lambda a: jnp.asarray(a)) if api is japi else _tt
    for i in range(0, len(keys), chunk):
        cols = {"k": mk(keys[i:i + chunk])}
        if vals is not None:
            cols["v"] = mk(vals[i:i + chunk])
        yield (JTable if api is japi else TTable)(cols)


@pytest.mark.parametrize("dist", ["zipf", "uniform", "heavy_unique"])
def test_auto_strategy_resolves_and_matches(dist):
    """Mirrors tests/test_plan_api.py::test_auto_strategy_resolves_and_matches."""
    rng = np.random.default_rng(3)
    keys = _keys(dist, 4096, rng)
    vals = rng.normal(size=4096).astype(np.float32)
    jp, tp = _plans(strategy="auto", saturation="grow", raw_keys=True)
    jout = jp.run(JTable({"k": jnp.asarray(keys), "v": jnp.asarray(vals)}))
    tout = tp.run(TTable({"k": _tt(keys), "v": _tt(vals)}))
    _assert_maps_close(_map(tout, "sum(v)"), _map(jout, "sum(v)"))
    assert _map(tout, "count(*)") == _map(jout, "count(*)")


def test_the_default_plan_and_groupby_match_reference():
    """``GroupByPlan(keys, aggs)`` with every default, and ``groupby()``,
    on hash-combined keys of two columns."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 40, size=3000).astype(np.int32)
    b = rng.integers(0, 7, size=3000).astype(np.int32)
    jt = JTable({"a": jnp.asarray(a), "b": jnp.asarray(b)})
    tt = TTable({"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    jout = japi.GroupByPlan(keys=("a", "b"), aggs=(japi.AggSpec("count"),)).run(jt)
    tout = tapi.GroupByPlan(keys=("a", "b"), aggs=(tapi.AggSpec("count"),),
                            execution=tapi.ExecutionPolicy(device="cpu")).run(tt)
    assert _map(tout, "count(*)") == _map(jout, "count(*)")
    jout = jgb.groupby(jt, ["a", "b"], [jgb.AggSpec("count")])
    tout = tgb.groupby(tt, ["a", "b"], [tgb.AggSpec("count")], device="cpu")
    assert _map(tout, "count(*)") == _map(jout, "count(*)")
    assert len(_map(tout, "count(*)")) == len(set(zip(a.tolist(), b.tolist())))


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_hybrid_matches_oracle_heavy_hitter(kind):
    """Mirrors tests/test_beyond_paper.py::test_hybrid_matches_oracle_heavy_hitter,
    through both packages' ``hybrid_groupby``."""
    rng = np.random.default_rng(9)
    n = 8192
    keys = rng.integers(0, 500, size=n).astype(np.uint32)
    keys[: n // 2] = 7
    keys[n // 2: n // 2 + n // 4] = 13
    vals = rng.normal(size=n).astype(np.float32)
    heavy = thy.detect_heavy_hitters(_tt(keys), num_registers=8)
    assert 7 in heavy and 13 in heavy
    t = thy.hybrid_groupby(_tt(keys), _tt(vals), heavy, kind=kind, max_groups=1024,
                           device="cpu")
    j = jhy.hybrid_groupby(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(heavy),
                           kind=kind, max_groups=1024)
    ref = groupby_oracle(jnp.asarray(keys), jnp.asarray(vals), kind=kind, max_groups=1024)
    as_map = (lambda r: dict(zip(np.asarray(r.keys)[:int(r.num_groups)].astype(np.int64).tolist(),
                                 np.asarray(r.values)[:int(r.num_groups)].tolist())))
    assert int(t.num_groups) == int(j.num_groups)
    assert np.array_equal(np.asarray(t.keys), np.asarray(j.keys).astype(np.int64))  # ticket order
    _assert_maps_close(as_map(t), as_map(j))
    _assert_maps_close(as_map(t), as_map(ref), rtol=1e-4)


def test_hybrid_no_heavy_hitters_degrades_gracefully():
    """Mirrors tests/test_beyond_paper.py::test_hybrid_no_heavy_hitters_degrades_gracefully."""
    keys = np.random.default_rng(9).permutation(2048).astype(np.uint32)
    heavy = thy.detect_heavy_hitters(_tt(keys), num_registers=8)
    assert (heavy == EMPTY).all()
    res = thy.hybrid_groupby(_tt(keys), None, heavy, kind="count", max_groups=4096,
                             device="cpu")
    n = int(res.num_groups)
    assert n == 2048 and float(res.values[:n].sum()) == 2048.0


@pytest.mark.parametrize("saturation", ["raise", "grow"])
def test_hybrid_stream_matches_reference(saturation):
    """Mirrors tests/test_plan_api.py::test_legacy_hybrid_shim_matches_oracle
    as an 8-chunk stream with four aggregates (a GROW stream from a bound
    below the distinct count)."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 3000, size=4096).astype(np.uint32)
    keys[: 2048] = 7
    rng.shuffle(keys)
    vals = rng.normal(size=4096).astype(np.float32)
    aggs = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"), ("min", "v"))
    jp, tp = _plans(strategy="hybrid", raw_keys=True, saturation=saturation, aggs=aggs,
                    max_groups=4096 if saturation == "raise" else 256)
    outs = []
    for api, plan in ((japi, jp), (tapi, tp)):
        handle = plan.stream(_chunks(api, keys, vals))
        handle.pump(4)
        first = handle.snapshot()  # a read: the registers stay out of the tail state
        assert _map(handle.snapshot(), "count(*)") == _map(first, "count(*)")
        outs.append(handle.result())
        assert handle.peak_buffered_chunks == 0
    jout, tout = outs
    assert np.array_equal(np.asarray(tout["key"]), np.asarray(jout["key"]).astype(np.int64))
    for col in ("count(*)", "max(v)", "min(v)"):
        assert _map(tout, col) == _map(jout, col), col
    for col in ("sum(v)", "mean(v)"):
        _assert_maps_close(_map(tout, col), _map(jout, col))
    with pytest.raises(ValueError, match="repeat"):
        tex.make_executor(dataclasses.replace(tp, execution=dataclasses.replace(
            tp.execution, heavy_keys=np.array([5, 5], np.uint32))))


def test_auto_replans_hash_to_hybrid_midstream():
    """Mirrors tests/test_stream.py::test_auto_replans_hash_to_hybrid_midstream
    (same seed): both resolvers escalate and the counts are exact."""
    rng = np.random.default_rng(23)
    n_chunk, n_chunks = 8192, 6
    parts = []
    for i in range(n_chunks):
        k = rng.integers(0, 20000, size=n_chunk).astype(np.uint32)
        if i >= 2:
            k[rng.random(n_chunk) < 0.5] = 7
        parts.append(k)
    keys = np.concatenate(parts)
    want = {int(k): float(c) for k, c in zip(*np.unique(keys, return_counts=True))}
    jp, tp = _plans(aggs=(("count", None),), raw_keys=True)
    seen = {}
    for api, plan, names in ((japi, jp, jex), (tapi, tp, tex)):
        handle = plan.stream(_chunks(api, keys, chunk=n_chunk))
        handle.pump(2)
        resolver = handle._ex
        assert isinstance(resolver._inner, names._ScanExecutor)
        escalated_at = None
        while handle.pump(1):
            if escalated_at is None and resolver._escalated:
                escalated_at = handle.chunks_consumed
        out = handle.result()
        assert isinstance(resolver._inner, names._HybridExecutor) and resolver._escalated
        assert _map(out, "count(*)") == want
        seen[api] = (escalated_at, list(resolver._stats.heavy_keys),
                     dataclasses.astuple(resolver._stats.stats))
    assert seen[japi] == seen[tapi]


def test_direct_ticketing_streams_without_buffering():
    """Mirrors tests/test_stream.py::test_direct_ticketing_streams_without_buffering."""
    rng = np.random.default_rng(11)
    keys = np.concatenate([np.arange(300, dtype=np.uint32),
                           rng.integers(0, 300, size=4096 - 300).astype(np.uint32)])
    rng.shuffle(keys)
    vals = rng.normal(size=4096).astype(np.float32)
    jp, tp = _plans(strategy="concurrent", max_groups=512, saturation="raise", raw_keys=True,
                    aggs=(("count", None), ("sum", "v")),
                    execution=dict(ticketing="direct", key_domain=300))
    jout = jp.collect(_chunks(japi, keys, vals))
    handle = tp.stream(_chunks(tapi, keys, vals))
    tout = handle.result()
    assert handle.peak_buffered_chunks == 0 and handle.chunks_consumed == 8
    assert np.array_equal(np.asarray(tout["key"]), np.asarray(jout["key"]).astype(np.int64))
    assert _map(tout, "count(*)") == _map(jout, "count(*)")
    _assert_maps_close(_map(tout, "sum(v)"), _map(jout, "sum(v)"))


@pytest.mark.parametrize("kernel", [None, "scan_body"])
def test_direct_ticketing_grows_domain_midstream(kernel):
    """Mirrors tests/test_stream.py::test_direct_ticketing_grows_domain_midstream
    (also with the segment kernel's update)."""
    rng = np.random.default_rng(13)
    keys = np.concatenate([rng.integers(0, 64, size=2048), rng.integers(0, 500, size=2048)]
                          ).astype(np.uint32)
    jp, tp = _plans(strategy="concurrent", max_groups=64, saturation="grow", raw_keys=True,
                    aggs=(("count", None),), execution=dict(ticketing="direct"))
    tp = dataclasses.replace(tp, execution=dataclasses.replace(tp.execution, kernel=kernel))
    jout = jp.collect(_chunks(japi, keys))
    handle = tp.stream(_chunks(tapi, keys))
    tout = handle.result()
    assert handle.peak_buffered_chunks == 0
    n = int(tout["__num_groups__"][0])
    assert n == int(jout["__num_groups__"][0])
    np.testing.assert_array_equal(tout["count(*)"].numpy(), np.asarray(jout["count(*)"]))
    np.testing.assert_array_equal(tout["key"].numpy()[:n], np.arange(n))


def test_direct_ticketing_raise_on_stream_overflow():
    """Mirrors tests/test_stream.py::test_direct_ticketing_raise_on_stream_overflow."""
    keys = np.random.default_rng(14).integers(0, 500, size=4096).astype(np.uint32)
    for api, plan in zip((japi, tapi), _plans(strategy="concurrent", max_groups=64,
                                              saturation="raise", raw_keys=True,
                                              aggs=(("count", None),),
                                              execution=dict(ticketing="direct"))):
        with pytest.raises(api.GroupByOverflowError, match="direct-ticketing overflow"):
            plan.collect(_chunks(api, keys))


def test_direct_ticketing_needs_raw_keys_and_a_bounded_domain():
    _, tp = _plans(strategy="concurrent", max_groups=64, aggs=(("count", None),),
                   execution=dict(ticketing="direct"))
    with pytest.raises(ValueError, match="raw_keys"):
        tex.make_executor(tp)
    _, tp = _plans(strategy="concurrent", max_groups=64, saturation="grow", raw_keys=True,
                   aggs=(("count", None),), execution=dict(ticketing="direct"))
    sparse = np.array([3, 1 << 20], np.uint32)
    with pytest.raises(tapi.GroupByOverflowError, match="too sparse"):
        tp.collect(_chunks(tapi, sparse))
