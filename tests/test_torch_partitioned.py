"""The remaining single-device plans of repro_torch on the CPU (the
kernels' plain versions) vs the JAX package: the new hashes, the
pre-aggregation of the partitioned baseline (``kernels.preagg``) against
JAX ``preagg_morsel`` and its ``lax.scan`` over morsels, ``_partitioned_impl``
and ``partitioned_groupby``, partitioned plans under every saturation
policy, sort-ticketing plans (``_SortExecutor``) and ``engine/plans.py``.

Tolerances: the pre-aggregation's table keys, spill mask and counts are
bit-exact (the same claim votes), its partial sums to rtol 1e-5 (another
order of float additions); result maps hold COUNT / MIN / MAX exactly and
SUM within 1e-4·Σ|v| of the group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import partitioned as jp
from repro.engine import executors as jex
from repro.engine import plan_api as japi
from repro.engine import plans as jplans
from repro_torch.core import hashing as th
from repro_torch.core import partitioned as tp
from repro_torch.core.aggregation import groupby_oracle
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine import plans as tplans
from repro_torch.engine.columns import Table
from repro_torch.engine.groupby import GroupByOverflowError
from repro_torch.kernels import preagg as pa

KINDS = ("sum", "count", "min", "max")


def _keys(rng, n, card, empty=0.1, high=0.2):
    """uint32 keys over ``card`` values, some EMPTY, some moved past 2^31."""
    keys = rng.integers(0, card, size=n).astype(np.uint32)
    keys[rng.random(n) < high] += np.uint32(1 << 31)
    keys[rng.random(n) < empty] = 0xFFFFFFFF
    return keys


def _t(keys):
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))


def _map(keys, vals, n):
    keys = np.asarray(keys)[:n].astype(np.int64) & 0xFFFFFFFF
    return dict(zip(keys.tolist(), np.asarray(vals)[:n].tolist()))


def _res_map(res):
    return _map(res.keys, res.values, int(res.num_groups))


def _table_map(out, col):
    n = int(np.asarray(out["__num_groups__"])[0])
    return _map(out["key"], out[col], n)


def _abs_sums(keys, vals):
    live = keys != 0xFFFFFFFF
    uk, inv = np.unique(keys[live], return_inverse=True)
    a = np.zeros(uk.size)
    np.add.at(a, inv, np.abs(vals[live].astype(np.float64)))
    return dict(zip(uk.astype(np.int64).tolist(), a.tolist()))


def _assert_maps(got, want, kind, absums):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if kind == "sum":
            assert abs(got[k] - w) <= 1e-4 * absums[k] + 1e-6, k
        else:
            assert got[k] == w, k


# -- hashes ---------------------------------------------------------------------


def test_murmur3_fmix64_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    x[:4] = [0, 1 << 63, 2**64 - 1, 1 << 32]
    k32 = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    with jax.enable_x64(True):
        want = np.asarray(jh.murmur3_fmix64(jnp.asarray(x)))
        want32 = np.asarray(jh.murmur3_fmix64(jnp.asarray(k32)))
    got = th.murmur3_fmix64(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    got32 = th.murmur3_fmix64(_t(k32)).numpy().view(np.uint64)  # int32 bits widen as uint32
    assert np.array_equal(got, want) and np.array_equal(got32, want32)


@pytest.mark.parametrize("log2_buckets", [1, 8, 16, 31])
def test_multiply_shift_bit_exact(log2_buckets):
    k = np.random.default_rng(2).integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 3):
        want = np.asarray(jh.multiply_shift(jnp.asarray(k), log2_buckets, seed))
        got = th.multiply_shift(_t(k), log2_buckets, seed).numpy()
        assert np.array_equal(got, want)


# -- pre-aggregation ------------------------------------------------------------


def _jax_preagg(keys, vals, kind, capacity, msize):
    """The reference's per-worker loop as ``_partitioned_impl`` runs it: a
    vmap over workers of a lax.scan of ``preagg_morsel`` over morsels."""
    w, r = keys.shape
    msize = msize or r

    def worker(kc, vc):
        st, spills = jax.lax.scan(
            lambda st, m: jp.preagg_morsel(st, m[0], m[1], kind),
            jp.make_preagg(capacity, kind), (kc.reshape(-1, msize), vc.reshape(-1, msize)))
        return st, spills.reshape(-1)

    st, spill = jax.vmap(worker)(jnp.asarray(keys), jnp.asarray(vals))
    return (np.asarray(st.keys), np.asarray(st.vals), np.asarray(st.cnts),
            np.asarray(spill))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("morsel", [None, 64])
@pytest.mark.parametrize("capacity", [64, 1024])
@pytest.mark.parametrize("workers", [1, 8])
def test_preagg_plain_matches_jax(workers, capacity, morsel, kind):
    rng = np.random.default_rng(workers * 7 + capacity + (morsel or 0))
    n = 1 << 12
    keys = _keys(rng, n, 600).reshape(workers, -1)
    vals = rng.normal(size=n).astype(np.float32).reshape(workers, -1)
    jk, jv, jc, js = _jax_preagg(keys, vals, kind, capacity, morsel)
    tk_, tv, tc, ts = pa.preagg(_t(keys), torch.from_numpy(vals), kind=kind,
                                capacity=capacity, morsel=morsel)
    assert np.array_equal(tk_.numpy().view(np.uint32), jk)
    assert np.array_equal(ts.numpy(), js)
    assert np.array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    # the wrapper's CPU path is the plain version
    again = pa.preagg_plain(_t(keys), torch.from_numpy(vals), kind=kind, capacity=capacity,
                            morsel=morsel)
    assert all(torch.equal(a, b) for a, b in zip(again, (tk_, tv, tc, ts)))


def _first_row_rule(keys, vals, kind, capacity):
    """The card kernel's closed form: slot s of worker w holds the key of w's
    first live row whose slot_hash is s; a live row folds iff its slot
    holds its key, else it spills."""
    w, r = keys.shape
    live = keys != th.EMPTY_I32
    slot = (torch.arange(w)[:, None] * capacity + th.slot_hash(keys, capacity)).reshape(-1)
    park = w * capacity
    row = torch.arange(r).expand(w, r).reshape(-1)
    first = torch.full((park + 1,), r, dtype=torch.int64)
    first.scatter_reduce_(0, torch.where(live.reshape(-1), slot, park), row, "amin")
    first = first[:park].reshape(w, capacity)
    tkeys = torch.where(first < r, keys.gather(1, first.clamp(max=max(r - 1, 0))),
                        th.EMPTY_I32)
    fold = live & (tkeys.reshape(-1)[slot].reshape(w, r) == keys)
    at = torch.where(fold.reshape(-1), slot, park)
    cnts = torch.zeros(park + 1).index_add_(0, at, fold.reshape(-1).float())[:park]
    if kind in ("sum", "count"):
        v = torch.ones(w * r) if kind == "count" else vals.reshape(-1)
        tvals = torch.zeros(park + 1).index_add_(0, at, torch.where(fold.reshape(-1), v, 0.0))
    else:
        neutral = float("inf") if kind == "min" else float("-inf")
        tvals = torch.full((park + 1,), neutral).scatter_reduce_(
            0, at, vals.reshape(-1), "amin" if kind == "min" else "amax")
    return (tkeys, tvals[:park].reshape(w, capacity), cnts.reshape(w, capacity),
            live & ~fold)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("morsel", [None, 1, 64])
@pytest.mark.parametrize("capacity", [16, 1024])
@pytest.mark.parametrize("workers", [1, 8])
def test_first_row_rule_matches_jax(workers, capacity, morsel, kind):
    """The rule the card kernel computes, whatever the morsel size: equal to
    JAX ``preagg_morsel`` under its vmap + lax.scan at that morsel size, and
    to ``preagg_plain``."""
    rng = np.random.default_rng(workers * 13 + capacity + (morsel or 0))
    n = 1 << 11
    keys = _keys(rng, n, 400, empty=0.05).reshape(workers, -1)
    vals = rng.normal(size=n).astype(np.float32).reshape(workers, -1)
    rk, rv, rc, rs = _first_row_rule(_t(keys), torch.from_numpy(vals), kind, capacity)
    jk, jv, jc, js = _jax_preagg(keys, vals, kind, capacity, morsel)
    pk, pv, pc, ps = pa.preagg_plain(_t(keys), torch.from_numpy(vals), kind=kind,
                                     capacity=capacity, morsel=morsel)
    assert np.array_equal(rk.numpy().view(np.uint32), jk) and torch.equal(rk, pk)
    assert np.array_equal(rs.numpy(), js) and torch.equal(rs, ps)
    assert np.array_equal(rc.numpy(), jc) and torch.equal(rc, pc)
    if kind == "sum":
        np.testing.assert_allclose(rv.numpy(), jv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rv.numpy(), pv.numpy(), rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(rv.numpy(), jv) and torch.equal(rv, pv)


def test_preagg_morsel_carries_state_like_jax():
    """Mirror of test_system's headline claim: at high cardinality a small
    pre-aggregation table spills most rows — the port's one-morsel step,
    with its state carried into a second morsel, bit for bit with JAX."""
    rng = np.random.default_rng(0)
    n = 1 << 14
    keys = rng.integers(0, n // 2, size=n).astype(np.uint32)
    keys[:100] += np.uint32(1 << 31)
    vals = rng.normal(size=n).astype(np.float32)
    js, ts = jp.make_preagg(256, "count"), tp.make_preagg(256, "count")
    for lo in (0, 4096):
        js, jspill = jp.preagg_morsel(js, jnp.asarray(keys[lo:lo + 4096]),
                                      jnp.asarray(vals[lo:lo + 4096]), "count")
        ts, tspill = tp.preagg_morsel(ts, _t(keys[lo:lo + 4096]),
                                      torch.from_numpy(vals[lo:lo + 4096]), "count")
        assert np.array_equal(tspill.numpy(), np.asarray(jspill))
        assert np.array_equal(ts.keys.numpy().view(np.uint32), np.asarray(js.keys))
        assert np.array_equal(ts.cnts.numpy(), np.asarray(js.cnts))
        assert np.array_equal(ts.vals.numpy(), np.asarray(js.vals))
    frac = float(tspill.to(torch.float32).mean())
    assert frac > 0.5, f"high-cardinality preagg should spill most rows, got {frac}"


def test_preagg_rejects_bad_shapes():
    keys = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of 2"):
        pa.preagg(keys, None, kind="count", capacity=48)
    with pytest.raises(ValueError, match="multiple of morsel"):
        pa.preagg(keys, None, kind="count", capacity=64, morsel=3)
    with pytest.raises(ValueError, match="unknown kind"):
        pa.preagg(keys, keys.float(), kind="mean", capacity=64)
    with pytest.raises(ValueError, match="int32"):
        pa.preagg(keys.to(torch.int64), None, kind="count", capacity=64)


# -- the pipeline and its adapter -----------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_partitioned_impl_matches_jax(kind):
    rng = np.random.default_rng(11)
    n = 1 << 13
    keys = _keys(rng, n, 3000)
    vals = rng.normal(size=n).astype(np.float32)
    want = _res_map(jp._partitioned_impl(jnp.asarray(keys), jnp.asarray(vals), kind=kind,
                                         max_groups=4096, num_workers=8,
                                         preagg_capacity=256, morsel_size=256))
    res = tp._partitioned_impl(_t(keys), torch.from_numpy(vals), kind=kind, max_groups=4096,
                               num_workers=8, preagg_capacity=256, morsel_size=256)
    assert res.keys.dtype == torch.int32
    _assert_maps(_res_map(res), want, kind, _abs_sums(keys, vals))
    with pytest.raises(ValueError, match="multiple of num_workers"):
        tp._partitioned_impl(_t(keys[:-1]), None, kind="count", max_groups=64)


@pytest.mark.parametrize("kind", KINDS)
def test_partitioned_groupby_matches_oracle(kind):
    """Mirror of test_core.test_partitioned_matches_oracle, against the
    port's oracle and JAX ``partitioned_groupby``."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, size=512).astype(np.uint32)
    vals = rng.normal(size=512).astype(np.float32)
    got = _res_map(tp.partitioned_groupby(_t(keys), torch.from_numpy(vals), kind=kind,
                                          max_groups=64, num_workers=8, preagg_capacity=64,
                                          device="cpu"))
    ref = _res_map(groupby_oracle(_t(keys), torch.from_numpy(vals), kind=kind, max_groups=64))
    jax_got = _res_map(jp.partitioned_groupby(jnp.asarray(keys), jnp.asarray(vals), kind=kind,
                                              max_groups=64, num_workers=8,
                                              preagg_capacity=64))
    absums = _abs_sums(keys, vals)
    _assert_maps(got, ref, kind, absums)
    _assert_maps(got, jax_got, kind, absums)


# -- partitioned plans ------------------------------------------------------------


def _chunks_t(keys, vals, rows):
    return [Table({"k": _t(keys[i:i + rows]), "v": torch.from_numpy(vals[i:i + rows])})
            for i in range(0, len(keys), rows)]


def _chunks_j(keys, vals, rows):
    return [japi.Table({"k": jnp.asarray(keys[i:i + rows]), "v": jnp.asarray(vals[i:i + rows])})
            for i in range(0, len(keys), rows)]


def _part_plans(agg, **kw):
    ex = dict(num_workers=8, preagg_capacity=64)
    ex.update(kw.pop("execution", {}))
    t = tapi.GroupByPlan(keys=("k",), aggs=(tapi.AggSpec(*agg),), strategy="partitioned",
                         raw_keys=True, execution=tapi.ExecutionPolicy(device="cpu", **ex),
                         **kw)
    j = japi.GroupByPlan(keys=("k",), aggs=(japi.AggSpec(*agg),), strategy="partitioned",
                         raw_keys=True, execution=japi.ExecutionPolicy(**ex), **kw)
    return t, j


@pytest.mark.parametrize("saturation,max_groups", [("raise", 1024), ("grow", 64),
                                                   ("unchecked", 1024)])
@pytest.mark.parametrize("kind", KINDS)
def test_partitioned_plans_match_jax(kind, saturation, max_groups):
    rng = np.random.default_rng(3)
    n = 1 << 12
    keys = _keys(rng, n, 500, empty=0.05)
    vals = rng.normal(size=n).astype(np.float32)
    agg = (kind,) if kind == "count" else (kind, "v")
    tplan, jplan = _part_plans(agg, max_groups=max_groups, saturation=saturation)
    handle = tplan.stream(_chunks_t(keys, vals, 1024))
    out = handle.result()
    # equal chunks: the reference's merge takes only chunks whose exchange
    # holds at least max_groups rows
    jout = jplan.collect(_chunks_j(keys, vals, 1024))
    col = tapi.AggSpec(*agg).name
    _assert_maps(_table_map(out, col), _table_map(jout, col), kind, _abs_sums(keys, vals))
    assert isinstance(handle.executor, tex._PartitionedExecutor)
    assert (handle.executor.reruns >= 1) == (saturation == "grow")


def test_partitioned_raise_overflows_like_jax():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 500, size=2048).astype(np.uint32)
    vals = np.ones(2048, np.float32)
    tplan, jplan = _part_plans(("sum", "v"), max_groups=64, saturation="raise")
    with pytest.raises(GroupByOverflowError, match="GROUP BY overflow"):
        tplan.collect(_chunks_t(keys, vals, 1024))
    with pytest.raises(RuntimeError, match="GROUP BY overflow"):
        jplan.collect(_chunks_j(keys, vals, 1024))


def test_partitioned_short_chunk_merges():
    """Chunks whose exchange holds fewer rows than the bound (every chunk
    here, and the last, ragged one) merge: a partial is longer than its
    keys."""
    rng = np.random.default_rng(5)
    keys = _keys(rng, 3000, 700, empty=0.0, high=0.3)
    vals = rng.normal(size=3000).astype(np.float32)
    tplan, _ = _part_plans(("min", "v"), max_groups=2048, saturation="raise")
    out = tplan.collect(_chunks_t(keys, vals, 1000) + _chunks_t(keys[:40], vals[:40], 40))
    k2, v2 = np.concatenate([keys, keys[:40]]), np.concatenate([vals, vals[:40]])
    ref = _res_map(groupby_oracle(_t(k2), torch.from_numpy(v2), kind="min", max_groups=2048))
    _assert_maps(_table_map(out, "min(v)"), ref, "min", None)


@pytest.mark.parametrize("aggs", [(("mean", "v"),), (("count",), ("sum", "v"))])
def test_partitioned_single_agg_value_error_matches_reference(aggs):
    msgs = []
    for api, make in ((tapi, tex.make_executor), (japi, jex.make_executor)):
        ex = api.ExecutionPolicy(device="cpu") if api is tapi else api.ExecutionPolicy()
        plan = api.GroupByPlan(keys=("k",), aggs=tuple(api.AggSpec(*a) for a in aggs),
                               strategy="partitioned", max_groups=64, execution=ex)
        with pytest.raises(ValueError) as err:
            make(plan)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- sort ticketing -------------------------------------------------------------


def _sort_plans(aggs, **kw):
    ex = kw.pop("execution", {})
    t = tapi.GroupByPlan(keys=("k",), aggs=tuple(tapi.AggSpec(*a) for a in aggs),
                         strategy="concurrent", raw_keys=True,
                         execution=tapi.ExecutionPolicy(device="cpu", ticketing="sort", **ex),
                         **kw)
    j = japi.GroupByPlan(keys=("k",), aggs=tuple(japi.AggSpec(*a) for a in aggs),
                         strategy="concurrent", raw_keys=True,
                         execution=japi.ExecutionPolicy(ticketing="sort", **ex), **kw)
    return t, j


@pytest.mark.parametrize("update", ["scatter", "sort_segment", "onehot", "scan_body"])
def test_sort_ticketing_is_oneshot_and_buffers(update):
    """Mirror of test_stream.test_sort_ticketing_is_oneshot_and_buffers,
    every aggregate, against the JAX sort plan and the oracle."""
    rng = np.random.default_rng(42)
    keys = _keys(rng, 4096, 300, empty=0.02)
    vals = rng.normal(size=4096).astype(np.float32)
    aggs = (("count",), ("sum", "v"), ("min", "v"), ("max", "v"), ("mean", "v"))
    ex = dict(kernel="scan_body") if update == "scan_body" else dict(update=update)
    tplan, jplan = _sort_plans(aggs, max_groups=1024, execution=ex)
    handle = tplan.stream(_chunks_t(keys, vals, 512))
    out = handle.result()
    assert handle.peak_buffered_chunks == 8  # the documented pipeline breaker
    assert isinstance(handle.executor, tex._SortExecutor)
    jout = jplan.collect(_chunks_j(keys, vals, 512))
    absums = _abs_sums(keys, vals)
    for a in aggs:
        col = tapi.AggSpec(*a).name
        kind = "sum" if a[0] == "mean" else a[0]
        _assert_maps(_table_map(out, col), _table_map(jout, col), kind, absums)
    live = keys[keys != 0xFFFFFFFF]
    counts = dict(zip(*np.unique(live, return_counts=True)))
    assert _table_map(out, "count(*)") == {int(k): float(c) for k, c in counts.items()}


def test_sort_ticketing_raises_and_grows():
    rng = np.random.default_rng(43)
    keys = rng.integers(0, 300, size=2048).astype(np.uint32)
    vals = rng.normal(size=2048).astype(np.float32)
    tplan, jplan = _sort_plans((("count",),), max_groups=64, saturation="raise")
    with pytest.raises(GroupByOverflowError, match="GROUP BY overflow"):
        tplan.collect(_chunks_t(keys, vals, 512))
    with pytest.raises(RuntimeError, match="GROUP BY overflow"):
        jplan.collect(_chunks_j(keys, vals, 512))
    tplan, jplan = _sort_plans((("count",),), max_groups=64, saturation="grow")
    out = tplan.collect(_chunks_t(keys, vals, 512))
    jout = jplan.collect(_chunks_j(keys, vals, 512))
    assert _table_map(out, "count(*)") == _table_map(jout, "count(*)")
    assert len(_table_map(out, "count(*)")) == len(np.unique(keys))


# -- engine/plans.py --------------------------------------------------------------


def test_plans_aggregate_strategy_is_one_field():
    """Mirror of test_plan_api.test_plans_aggregate_strategy_is_one_field
    (``"pallas"`` dropped, ``"partitioned"`` kept), against the JAX plans."""
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 300, size=4096).astype(np.uint32)
    vals = np.abs(rng.normal(size=4096)).astype(np.float32)
    t = Table({"k": _t(keys), "v": torch.from_numpy(vals)})
    jt = japi.Table({"k": jnp.asarray(keys), "v": jnp.asarray(vals)})
    outs = {}
    for strategy in ("concurrent", "partitioned"):
        agg = tplans.Aggregate(keys=["k"], aggs=[tapi.AggSpec("sum", "v")], max_groups=512,
                               strategy=strategy,
                               execution=tapi.ExecutionPolicy(device="cpu"))
        outs[strategy] = _table_map(
            agg.run(tplans.Scan(t, chunk_rows=4096), tplans.Filter(lambda c: c["v"] > 0.5)),
            "sum(v)")
        jagg = jplans.Aggregate(keys=["k"], aggs=[japi.AggSpec("sum", "v")], max_groups=512,
                                strategy=strategy)
        want = _table_map(
            jagg.run(jplans.Scan(jt, chunk_rows=4096), jplans.Filter(lambda c: c["v"] > 0.5)),
            "sum(v)")
        assert outs[strategy].keys() == want.keys()
        for k, w in want.items():
            assert abs(outs[strategy][k] - w) < 1e-3, k
    base = outs.pop("concurrent")
    assert base  # the filter keeps a nonempty stream
    for k, w in base.items():
        assert abs(outs["partitioned"][k] - w) < 5e-2, k


def test_plans_scan_chunks_and_update_override():
    t = Table({"k": torch.arange(10, dtype=torch.int32), "v": torch.ones(10)})
    assert [c.num_rows for c in tplans.Scan(t, chunk_rows=4).chunks()] == [4, 4, 2]
    plan = tplans.Aggregate(keys=["k"], aggs=[tapi.AggSpec("count")], update="onehot",
                            execution=tapi.ExecutionPolicy(device="cpu")).plan()
    assert plan.execution.update == "onehot" and plan.execution.device == "cpu"
    assert plan.strategy == "concurrent" and plan.saturation is None


@pytest.mark.parametrize("kind", KINDS)
def test_concurrent_groupby_sort_ticketing_matches_jax(kind):
    from repro.core import concurrent_groupby as jcg
    from repro_torch.core.aggregation import concurrent_groupby as tcg

    rng = np.random.default_rng(44)
    keys = _keys(rng, 2048, 200, empty=0.0)
    vals = rng.normal(size=2048).astype(np.float32)
    got = _res_map(tcg(_t(keys), torch.from_numpy(vals), kind=kind, max_groups=512,
                       ticketing="sort", saturation="raise", device="cpu"))
    want = _res_map(jcg(jnp.asarray(keys), jnp.asarray(vals), kind=kind, max_groups=512,
                        ticketing="sort", saturation="raise"))
    _assert_maps(got, want, kind, _abs_sums(keys, vals))
