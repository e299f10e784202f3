"""The scan route of repro_torch (``GroupByOperator``, ``_ScanExecutor``,
``kernel`` ∈ {None, "off", "scan_body"}) vs the JAX package, on the CPU
(``device="cpu"``: the plain versions of the kernels).

Mirrors tests/test_scan_pipeline.py and tests/test_core.py's
``test_concurrent_matches_oracle``.  The same numpy inputs go through the
JAX operator or plan (``scan_body`` through the Pallas segment kernel in
interpret mode) and through the port.  Tolerances: ``key_by_ticket``, the
group count, migrations and bound grows exact; COUNT / MIN / MAX exact;
SUM within 1e-5 of the group's Σ|v| (the port updates a chunk's tickets in
one call, the reference a morsel at a time, so the float adds may run in
another order).  The card's kernels are held to these plain versions in
tests/test_torch_gpu.py."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import resize as jresize
from repro.core import ticketing as jtk
from repro.core import updates as jup
from repro.engine import plan_api as japi
from repro.engine.columns import Table as JTable
from repro.engine.columns import combine_keys as jcombine
from repro.obs import metrics as jmet
from repro_torch.core import aggregation as tagg
from repro_torch.core import resize as tresize
from repro_torch.core import ticketing as ttk
from repro_torch.core import updates as tup
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.columns import Table as TTable
from repro_torch.engine.columns import combine_keys as tcombine
from repro_torch.kernels import fused_groupby as tfk
from repro_torch.kernels import segment_agg as tsa
from repro_torch.obs import metrics as tmet

from test_torch_gpu import _serialized_edges

jgb = importlib.import_module("repro.engine.groupby")
tgb = importlib.import_module("repro_torch.engine.groupby")

SUM_RTOL = 1e-5
KINDS = ("sum", "count", "min", "max")
UPDATES = ("scatter", "onehot", "sort_segment", "serialized")
AGG4 = (("sum", "v"), ("count", None), ("min", "v"), ("max", "v"))


def _keys(n, card, rng):
    if card == "uniform":
        return rng.integers(0, 97, size=n).astype(np.uint32)
    if card == "skewed":
        return np.minimum(rng.zipf(1.3, size=n), 500).astype(np.uint32)
    assert card == "near_unique"
    return rng.permutation(2 * n)[:n].astype(np.uint32)


def _tt(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _ops(aggs=AGG4, **kw):
    """A JAX and a port GroupByOperator with the same fields."""
    jop = jgb.GroupByOperator(key_columns=["k"], aggs=[jgb.AggSpec(k, c) for k, c in aggs], **kw)
    top = tgb.GroupByOperator(key_columns=["k"], aggs=[tgb.AggSpec(k, c) for k, c in aggs],
                              device="cpu", **kw)
    return jop, top


def _feed(op, keys, vals, chunk, jax_side):
    for lo in range(0, keys.shape[0], chunk):
        k, v = keys[lo:lo + chunk], vals[lo:lo + chunk]
        if jax_side:
            op.consume(JTable({"k": jnp.asarray(k), "v": jnp.asarray(v)}))
        else:
            op.consume(TTable({"k": _tt(k), "v": _tt(v)}))


def _assert_results_equal(jout, tout, aggs, keys=None, vals=None):
    """Exact groups in ticket order; COUNT/MIN/MAX exact, SUM (and MEAN)
    within SUM_RTOL of the group's Σ|v|."""
    ng = int(np.asarray(jout["__num_groups__"])[0])
    assert int(tout["__num_groups__"][0]) == ng
    jk = np.asarray(jout["key"]).astype(np.int64)[:ng]
    assert np.array_equal(tout["key"].numpy()[:ng], jk)
    scale = None
    if keys is not None:
        order = {k: i for i, k in enumerate(jk.tolist())}
        scale = np.zeros(ng)
        idx = np.array([order.get(int(k), -1) for k in keys])
        ok = idx >= 0
        np.add.at(scale, idx[ok], np.abs(vals[ok]).astype(np.float64))
    for name in aggs:
        j, t = np.asarray(jout[name])[:ng], tout[name].numpy()[:ng]
        assert np.array_equal(np.isnan(j), np.isnan(t)), name
        if name.startswith(("sum", "mean")):
            ref = scale if scale is not None else np.abs(j)
            tol = SUM_RTOL * np.maximum(ref, 1.0)
            fin = ~np.isnan(j)
            assert (np.abs(t[fin] - j[fin]) <= tol[fin]).all(), name
        else:
            assert np.array_equal(j, t, equal_nan=True), name


# -- the scan pipeline (tests/test_scan_pipeline.py) ----------------------------


@pytest.mark.parametrize("card", ["uniform", "skewed", "near_unique"])
def test_scan_equals_host_loop_and_jax(card):
    rng = np.random.default_rng(11 + ["uniform", "skewed", "near_unique"].index(card))
    n = 4096
    keys, vals = _keys(n, card, rng), rng.normal(size=n).astype(np.float32)
    max_groups = int(np.unique(keys).size) + 8
    names = [f"{k}({c or '*'})" for k, c in AGG4]
    outs = {}
    for pipe in ("scan", "host"):
        jop, top = _ops(max_groups=max_groups, morsel_rows=512, pipeline=pipe)
        _feed(jop, keys, vals, 2048, True)
        _feed(top, keys, vals, 2048, False)
        jout, tout = jop.finalize(), top.finalize()
        _assert_results_equal(jout, tout, names, keys, vals)
        outs[pipe] = tout
    _assert_results_equal({k: v.numpy() for k, v in outs["host"].columns.items()},
                          outs["scan"], names, keys, vals)


def test_resize_during_consume_preserves_key_to_ticket_map():
    rng = np.random.default_rng(5)
    n = 2048
    keys = rng.permutation(4 * n)[:n].astype(np.uint32)
    jop, top = _ops(aggs=(("count", None),), max_groups=n, morsel_rows=256)
    jop._table = jtk.make_table(256, max_groups=n)
    top._table = ttk.make_table(256, max_groups=n)
    first, second = keys[: n // 2], keys[n // 2:]
    zeros = np.zeros(n // 2, np.float32)
    _feed(jop, first, zeros, n, True)
    _feed(top, first, zeros, n, False)
    probe = tcombine(_tt(first))
    pre = ttk.lookup(top._table, probe)
    assert (pre >= 0).all()
    assert np.array_equal(pre.numpy(), np.asarray(jtk.lookup(jop._table, jcombine(jnp.asarray(first)))))
    cap_before = top._table.capacity
    _feed(jop, second, zeros, n, True)
    _feed(top, second, zeros, n, False)
    assert top._table.capacity > cap_before
    assert top._table.capacity == jop._table.capacity
    assert torch.equal(ttk.lookup(top._table, probe), pre)
    assert int(top.num_groups) == n
    assert top.migrations == jop.migrations
    res = top.finalize()
    assert float(res["count(*)"].sum()) == n
    _assert_results_equal(jop.finalize(), res, ["count(*)"])


def test_mask_selection_vector_through_scan():
    rng = np.random.default_rng(7)
    n = 8192
    k = rng.integers(0, 50, size=n).astype(np.uint32)
    v = rng.integers(0, 10, size=n).astype(np.int32)
    keep = v > 4
    top = tgb.GroupByOperator(key_columns=["k"], aggs=[tgb.AggSpec("count"), tgb.AggSpec("sum", "v")],
                              max_groups=64, morsel_rows=1024, device="cpu")
    jop = jgb.GroupByOperator(key_columns=["k"], aggs=[jgb.AggSpec("count"), jgb.AggSpec("sum", "v")],
                              max_groups=64, morsel_rows=1024)
    for lo in range(0, n, 2048):
        sl = slice(lo, lo + 2048)
        top.consume(TTable({"k": _tt(k[sl]), "v": _tt(v[sl]), "__mask__": _tt(keep[sl])}))
        jop.consume(JTable({"k": jnp.asarray(k[sl]), "v": jnp.asarray(v[sl]),
                            "__mask__": jnp.asarray(keep[sl])}))
    res = top.finalize()
    ng = int(res["__num_groups__"][0])
    assert ng == np.unique(k[keep]).size
    assert float(res["count(*)"][:ng].sum()) == keep.sum()
    assert float(res["sum(v)"][:ng].sum()) == v[keep].sum()
    _assert_results_equal(jop.finalize(), res, ["count(*)", "sum(v)"])


def test_overflow_raises_in_both_packages():
    keys = np.arange(500, dtype=np.uint32)
    for side, cls in ((True, jgb.GroupByOverflowError), (False, tgb.GroupByOverflowError)):
        op = _ops(aggs=(("count", None),), max_groups=32, morsel_rows=128)[0 if side else 1]
        _feed(op, keys, np.zeros(500, np.float32), 500, side)
        with pytest.raises(cls, match="overflow"):
            op.finalize()


def test_kernel_route_is_a_scan_body():
    """use_kernel=True routes the updates through the segment kernel (its
    plain version here, the Pallas kernel in interpret mode for JAX)."""
    rng = np.random.default_rng(13)
    n = 2048
    keys, vals = rng.integers(0, 30, size=n).astype(np.uint32), rng.normal(size=n).astype(np.float32)
    names = [f"{k}({c or '*'})" for k, c in AGG4]
    jop, top = _ops(max_groups=32, morsel_rows=512, use_kernel=True)
    _feed(jop, keys, vals, n, True)
    _feed(top, keys, vals, n, False)
    _assert_results_equal(jop.finalize(), top.finalize(), names, keys, vals)


# -- plans: kernel × saturation × pipeline --------------------------------------


def _plan_pair(max_groups, saturation, kernel, update="scatter", pipeline="scan"):
    aggs = (("count", None), ("sum", "v"), ("mean", "v"), ("min", "v"), ("max", "v"))
    ex = dict(kernel=kernel, update=update, morsel_rows=256, pipeline=pipeline, instrument=True)
    jp = japi.GroupByPlan(keys=("k",), aggs=tuple(japi.AggSpec(k, c) for k, c in aggs),
                          strategy="concurrent", max_groups=max_groups, saturation=saturation,
                          raw_keys=True, execution=japi.ExecutionPolicy(**ex))
    tp = tapi.GroupByPlan(keys=("k",), aggs=tuple(tapi.AggSpec(k, c) for k, c in aggs),
                          strategy="concurrent", max_groups=max_groups, saturation=saturation,
                          raw_keys=True, execution=tapi.ExecutionPolicy(device="cpu", **ex))
    return jp, tp, [f"{k}({c or '*'})" for k, c in aggs]


def _stream_both(jp, tp, keys, vals, chunk=1024):
    jchunks = [JTable({"k": jnp.asarray(keys[i:i + chunk]), "v": jnp.asarray(vals[i:i + chunk])})
               for i in range(0, keys.shape[0], chunk)]
    tchunks = [TTable({"k": _tt(keys[i:i + chunk]), "v": _tt(vals[i:i + chunk])})
               for i in range(0, keys.shape[0], chunk)]
    jh, th = jp.stream(jchunks), tp.stream(tchunks)
    return jh, jh.result(), th, th.result()


PLAN_CASES = {
    # name: (kernel, saturation, max_groups, update, pipeline)
    "none_raise": (None, "raise", 1024, "scatter", "scan"),
    "off_grow": ("off", "grow", 64, "scatter", "scan"),
    "off_unchecked": ("off", "unchecked", 1024, "scatter", "scan"),
    "scan_body_raise": ("scan_body", "raise", 1024, "scatter", "scan"),
    "scan_body_grow_onehot": ("scan_body", "grow", 128, "onehot", "scan"),
    "off_grow_host": ("off", "grow", 64, "scatter", "host"),
    "sort_segment_grow": ("off", "grow", 64, "sort_segment", "scan"),
    "serialized_raise": ("off", "raise", 1024, "serialized", "scan"),
    "onehot_unchecked_host": (None, "unchecked", 1024, "onehot", "host"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_jax(case):
    kernel, saturation, g, update, pipeline = PLAN_CASES[case]
    rng = np.random.default_rng(21)
    n = 4096
    keys = rng.integers(0, 700, size=n).astype(np.uint32)
    vals = rng.normal(size=n).astype(np.float32)
    jp, tp, names = _plan_pair(g, saturation, kernel, update, pipeline)
    jh, jout, th, tout = _stream_both(jp, tp, keys, vals)
    _assert_results_equal(jout, tout, names, keys, vals)
    jdev, tdev = jh.stats()["device"], th.stats()["device"]
    for key in ("migrations", "bound_grows", "num_groups", "table_capacity", "morsels",
                "rows", "rows_masked", "probe_steps", "probe_saturations", "pauses",
                "probe_hist"):
        assert tdev[key] == jdev[key], key
    assert isinstance(th.executor, tex._ScanExecutor)
    if saturation == "grow":
        assert tdev["bound_grows"] >= 1
    assert tdev["device_table_bytes"] > 0


def test_raise_overflow_through_the_plan():
    keys = np.arange(600, dtype=np.uint32)
    vals = np.ones(600, np.float32)
    jp, tp, _ = _plan_pair(64, "raise", "off")
    with pytest.raises(jgb.GroupByOverflowError):
        jp.collect([JTable({"k": jnp.asarray(keys), "v": jnp.asarray(vals)})])
    with pytest.raises(tgb.GroupByOverflowError):
        tp.collect([TTable({"k": _tt(keys), "v": _tt(vals)})])


def test_unchecked_saturation_truncates_like_jax():
    """A table too small for the stream: both packages drop the same rows
    and keep the same groups (tickets, counts) without raising."""
    keys = np.random.default_rng(3).integers(0, 300, size=2048).astype(np.uint32)
    vals = np.ones(2048, np.float32)
    jp, tp, names = _plan_pair(128, "unchecked", "off")
    jp = jp.with_(execution=japi.ExecutionPolicy(morsel_rows=256, capacity=128))
    tp = tp.with_(execution=tapi.ExecutionPolicy(morsel_rows=256, capacity=128, device="cpu"))
    _, jout, _, tout = _stream_both(jp, tp, keys, vals)
    _assert_results_equal(jout, tout, names)


# -- core: concurrent_groupby vs the oracle (tests/test_core.py) ----------------


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    return rng.integers(0, 50, size=512).astype(np.uint32), rng.normal(size=512).astype(np.float32)


def _as_map(res):
    n = int(res.num_groups)
    ks = np.asarray(res.keys)[:n].astype(np.int64)
    return dict(zip(ks.tolist(), np.asarray(res.values)[:n].tolist()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("update", UPDATES)
def test_concurrent_matches_oracle(small, kind, update):
    keys, vals = small
    want = _as_map(jagg.groupby_oracle(jnp.asarray(keys), jnp.asarray(vals), kind=kind,
                                       max_groups=64))
    own = _as_map(tagg.groupby_oracle(_tt(keys), _tt(vals), kind=kind, max_groups=64))
    got_res = tagg.concurrent_groupby(_tt(keys), _tt(vals), kind=kind, update=update,
                                      max_groups=64, device="cpu")
    got = _as_map(got_res)
    assert want.keys() == own.keys() == got.keys()
    for k in want:
        assert abs(own[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k]))
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k]))
        if kind != "sum":
            assert got[k] == want[k]


@pytest.mark.parametrize("update", UPDATES)
def test_concurrent_groupby_tickets_like_jax(small, update):
    keys, vals = small
    j = jagg.concurrent_groupby(jnp.asarray(keys), jnp.asarray(vals), kind="sum", update=update,
                                max_groups=64, morsel_size=128)
    t = tagg.concurrent_groupby(_tt(keys), _tt(vals), kind="sum", update=update, max_groups=64,
                                morsel_size=128, device="cpu")
    n = int(j.num_groups)
    assert int(t.num_groups) == n
    assert np.array_equal(t.keys.numpy()[:n], np.asarray(j.keys)[:n].astype(np.int64))
    np.testing.assert_allclose(t.values.numpy()[:n], np.asarray(j.values)[:n], rtol=1e-5, atol=1e-5)


def test_concurrent_groupby_two_value_columns_and_as_group_result(small):
    keys, vals = small
    v2 = np.stack([vals, 2 * vals], axis=1)
    j = jagg.concurrent_groupby(jnp.asarray(keys), jnp.asarray(v2), kind="max", max_groups=64)
    t = tagg.concurrent_groupby(_tt(keys), _tt(v2), kind="max", max_groups=64, device="cpu")
    n = int(j.num_groups)
    assert t.values.shape == (64, 2)
    assert np.array_equal(t.values.numpy()[:n], np.asarray(j.values)[:n])
    out = tapi.execute(tapi.GroupByPlan(
        keys=("k",), aggs=(tapi.AggSpec("count"),), strategy="concurrent", max_groups=64,
        raw_keys=True, execution=tapi.ExecutionPolicy(device="cpu")),
        TTable({"k": _tt(keys)}))
    res = tapi.as_group_result(out, tapi.AggSpec("count"))
    assert isinstance(res, tagg.GroupByResult) and int(res.num_groups) == np.unique(keys).size


def test_unported_ticketings_and_auto_name_item_5(small):
    """Sort ticketing (ported with item 5b), direct ticketing and
    ``groupby()``'s default ``strategy="auto"`` run, as in the reference."""
    keys, vals = small
    js = jagg.concurrent_groupby(jnp.asarray(keys), jnp.asarray(vals), kind="sum",
                                 max_groups=64, ticketing="sort")
    ts = tagg.concurrent_groupby(_tt(keys), _tt(vals), kind="sum", max_groups=64,
                                 ticketing="sort", device="cpu")
    assert int(ts.num_groups) == int(js.num_groups)
    assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys).astype(np.int64))
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values), rtol=1e-5, atol=1e-5)
    j = jagg.concurrent_groupby(jnp.asarray(keys), jnp.asarray(vals), kind="sum",
                                max_groups=128, ticketing="direct")
    t = tagg.concurrent_groupby(_tt(keys), _tt(vals), kind="sum", max_groups=128,
                                ticketing="direct", device="cpu")
    assert int(t.num_groups) == int(j.num_groups) == 128
    assert np.array_equal(t.keys.numpy(), np.asarray(j.keys).astype(np.int64))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), rtol=1e-5, atol=1e-5)
    jout = jgb.groupby(JTable({"k": jnp.asarray(keys)}), ["k"], [jgb.AggSpec("count")])
    for strategy in ("auto", "concurrent"):
        kw = {} if strategy == "auto" else dict(strategy="concurrent", max_groups=64)
        out = tgb.groupby(TTable({"k": _tt(keys)}), ["k"], [tgb.AggSpec("count")],
                          device="cpu", **kw)
        assert int(out["__num_groups__"][0]) == np.unique(keys).size
        if strategy == "auto":
            assert _table_map(out, "count(*)") == _table_map(jout, "count(*)")


def _table_map(out, col):
    n = int(np.asarray(out["__num_groups__"])[0])
    return dict(zip(np.asarray(out["key"])[:n].astype(np.int64).tolist(),
                    np.asarray(out[col])[:n].tolist()))


# -- stage primitives -------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("update", UPDATES)
def test_update_fns_match_reference(kind, update):
    rng = np.random.default_rng(3 + KINDS.index(kind) + 4 * UPDATES.index(update))
    g = 48
    acc0 = (rng.normal(size=g) * 2).astype(np.float32) if kind != "count" else np.zeros(g, np.float32)
    t = rng.integers(-2, g + 3, size=300).astype(np.int32)
    v = rng.normal(size=300).astype(np.float32)
    want = np.asarray(jup.get_update_fn(update)(jnp.asarray(acc0), jnp.asarray(t), jnp.asarray(v),
                                                kind=kind))
    acc = torch.from_numpy(acc0.copy())
    got = tup.get_update_fn(update)(acc, _tt(t), _tt(v), kind=kind)
    assert got is acc  # in place
    if kind == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,g", [(3 * 1024 + 5, 24), (2 * 1024 + 3, 53 * 1024 + 1)])
def test_serialized_plain_matches_reference_on_edges(kind, n, g):
    """The serialized kernel's plain version (its oracle on the card) vs
    JAX ``serialized_update``, exactly: both fold rows one at a time in row
    order.  A ticket repeated one and two rows apart, tickets of -1 and
    >= g, a row count that is no multiple of the kernel's 1024-row tile,
    -0.0 and ±inf for min / max, and a plane past the kernel's
    shared-memory cap.  Compared by value (-0.0 == 0.0: XLA's scatter
    min / max may keep either zero of a tie)."""
    rng = np.random.default_rng(17 + KINDS.index(kind) + n)
    t, v, acc0 = _serialized_edges(rng, n, g, kind)
    want = np.asarray(jup.serialized_update(jnp.asarray(acc0), jnp.asarray(t), jnp.asarray(v),
                                            kind=kind))
    got = tsa.serialized_agg_plain(torch.from_numpy(acc0.copy()), _tt(t), _tt(v), kind=kind)
    assert np.array_equal(got.numpy(), want)


def test_agg_state_init_grow_update():
    s = tup.init_agg_state([("v", "sum"), (None, "count"), ("v", "sum"), ("v", "min")], 8)
    j = jup.init_agg_state([("v", "sum"), (None, "count"), ("v", "sum"), ("v", "min")], 8)
    assert s.specs == j.specs == (("v", "sum"), (None, "count"), ("v", "min"))
    t = np.array([0, 1, 1, -1, 7], np.int32)
    v = np.array([1.0, 2.0, 3.0, 9.0, -4.0], np.float32)
    s = tup.update_agg_state(s, _tt(t), {"v": _tt(v)}, tup.scatter_update)
    j = jup.update_agg_state(j, jnp.asarray(t), {"v": jnp.asarray(v)}, jup.scatter_update)
    s, j = tup.grow_agg_state(s, 12), jup.grow_agg_state(j, 12)
    assert s.num_groups == 12
    for spec in s.specs:
        assert np.array_equal(s.get(*spec).numpy(), np.asarray(j.get(*spec)))
    with pytest.raises(ValueError):
        tup.grow_agg_state(s, 4)
    with pytest.raises(ValueError):
        tup.get_update_fn("bogus")


def test_sort_and_direct_ticketing_match_reference():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 100, size=777).astype(np.uint32)
    keys[::50] = 0xFFFFFFFF
    keys[1::97] = 0x80000005  # sorts as unsigned, past 2^31
    jt, jk, jc = jtk.sort_ticketing(jnp.asarray(keys))
    tt, tk_, tc = ttk.sort_ticketing(_tt(keys))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tk_.numpy(), np.asarray(jk).view(np.int32))
    assert int(tc) == int(jc)
    dk = np.array([0, 3, 9, 10, 0xFFFFFFFF, 0x80000001], np.uint32)
    jt, jk, jc = jtk.direct_ticketing(jnp.asarray(dk), 10)
    tt, tk_, tc = ttk.direct_ticketing(_tt(dk), 10)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tk_.numpy(), np.asarray(jk).astype(np.int32))
    assert int(tc) == int(jc)


def test_maybe_resize_matches_reference():
    keys = np.arange(40, dtype=np.uint32)
    jt = jtk.make_table(64, max_groups=64)
    _, jt = jtk.get_or_insert(jt, jnp.asarray(keys))
    t = ttk.make_table(64, max_groups=64)
    _, t = ttk.get_or_insert(t, _tt(keys))
    jr, tr = jresize.maybe_resize(jt, 0.5), tresize.maybe_resize(t, 0.5)
    assert tr.capacity == jr.capacity == 128
    assert np.array_equal(tr.tickets.numpy(), np.asarray(jr.tickets))
    assert tresize.maybe_resize(tr, 0.5) is tr


@pytest.mark.parametrize("case", ["commit", "pause_sat", "halt_only", "masked"])
def test_accumulate_scan_events_matches_reference(case):
    rng = np.random.default_rng(17)
    mkeys = rng.integers(0, 1000, size=256).astype(np.uint32)
    if case == "masked":
        mkeys[::3] = 0xFFFFFFFF
    plen = rng.integers(0, 40, size=256).astype(np.int32)
    plen[mkeys == 0xFFFFFFFF] = 0
    commit, pause_sat, halt = {"commit": (True, False, False), "pause_sat": (False, True, True),
                               "halt_only": (False, False, True), "masked": (True, False, False)}[case]
    ev0 = rng.integers(0, 9, size=jmet.EVENT_VEC_LEN).astype(np.int32)
    want = jgb.accumulate_scan_events(jnp.asarray(ev0), jnp.asarray(mkeys), jnp.asarray(plen),
                                      jnp.asarray(commit), jnp.asarray(pause_sat), jnp.asarray(halt))
    got = tgb.accumulate_scan_events(torch.from_numpy(ev0), _tt(mkeys).to(torch.int32),
                                     torch.from_numpy(plen), commit, pause_sat, halt)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    assert tmet.EVENT_VEC_LEN == jmet.EVENT_VEC_LEN


@pytest.mark.parametrize("checked", [True, False])
def test_scan_ticket_plain_matches_get_or_insert(checked):
    """The ticket stage's plain version, morsels in order, ticket for ticket
    JAX's get_or_insert per morsel (no pause: thresholds above the count)."""
    rng = np.random.default_rng(23)
    km = rng.integers(0, 900, size=(8, 256)).astype(np.uint32)
    km[2, ::7] = 0xFFFFFFFF
    jt = jtk.make_table(2048, max_groups=1024)
    want = []
    for row in km:
        tick, jt = jtk.get_or_insert(jt, jnp.asarray(row))
        want.append(np.asarray(tick))
    t = ttk.make_table(2048, max_groups=1024)
    todo = torch.ones(8, dtype=torch.int32)
    ev = tmet.zero_event_vector()
    tickets, info = tfk.scan_ticket(t, _tt(km).to(torch.int32), todo, checked=checked,
                                    threshold=1024, collect_events=True, events=ev)
    assert np.array_equal(tickets.numpy(), np.stack(want))
    for name in ("keys", "tickets", "key_by_ticket", "count"):
        a = np.asarray(getattr(jt, name))
        assert np.array_equal(getattr(t, name).numpy(), a.view(np.int32) if a.dtype == np.uint32 else a)
    assert info.tolist() == [[int(jt.count), tfk.NO_HALT, 0, 0]]
    assert not bool(todo.any()) and int(ev[tmet.EVT_MORSELS]) == 8
    assert int(ev[tmet.EVT_ROWS]) == int((km != 0xFFFFFFFF).sum())


def test_scan_ticket_pause_leaves_minus_one_and_todo():
    """A GROW bound that runs out partway: the paused morsels keep their
    todo flag and get -1 tickets; the replay after growth tickets them."""
    rng = np.random.default_rng(29)
    km = torch.from_numpy(rng.permutation(4096)[:2048].reshape(8, 256).astype(np.int32))
    t = ttk.make_table(2048, max_groups=600)
    todo = torch.ones(8, dtype=torch.int32)
    tickets, info = tfk.scan_ticket(t, km, todo, checked=True, grow_bound=True,
                                    threshold=1024, bound_slack=600 - 256)
    first = int(info[0, tfk.INFO_FIRST_HALT])
    assert int(info[0, tfk.INFO_HALTED]) == 1 and first == 2 and int(t.count) <= 600
    assert bool((tickets[first:] == -1).all()) and bool((tickets[:first] >= 0).all())
    assert todo.tolist() == [0, 0, 1, 1, 1, 1, 1, 1]
    t = tresize.grow_bound(t, 2048)
    tickets2, info2 = tfk.scan_ticket(t, km, todo, checked=True, grow_bound=True,
                                      threshold=2048, bound_slack=2048 - 256)
    assert int(info2[0, tfk.INFO_HALTED]) == 0 and int(t.count) == 2048
    assert bool((tickets2[:first] == -1).all()) and bool((tickets2[first:] >= 0).all())
    assert not bool(t.overflowed)


def test_jax_operator_state_carries_into_the_port():
    """A JAX operator stops after chunk 1; the port continues with chunk 2
    from its state and ends where a JAX operator fed both chunks ends."""
    rng = np.random.default_rng(31)
    n = 4096
    keys, vals = rng.integers(0, 400, size=n).astype(np.uint32), rng.normal(size=n).astype(np.float32)
    names = [f"{k}({c or '*'})" for k, c in AGG4]
    kw = dict(max_groups=64, morsel_rows=256, grow_bound=True)
    jfirst, top = _ops(**kw)
    _feed(jfirst, keys[:n // 2], vals[:n // 2], n // 2, True)
    table, state = tgb.scan_state_from_numpy(
        [np.asarray(a) for a in jfirst._table], jfirst._state.specs,
        [np.asarray(a) for a in jfirst._state.accs])
    assert table.keys.dtype == torch.int32 and table.max_groups == jfirst.max_groups
    top.load_state(table, state)
    _feed(top, keys[n // 2:], vals[n // 2:], n // 2, False)
    jboth = _ops(**kw)[0]
    _feed(jboth, keys, vals, n // 2, True)
    _assert_results_equal(jboth.finalize(), top.finalize(), names, keys, vals)


def test_scan_ticket_discrepancies_counts_broken_maps():
    """The card's contract with the plain version, checked on the CPU: 0
    for the plain version against itself and against a renumbered copy,
    more than 0 when a row names another key's ticket."""
    rng = np.random.default_rng(37)
    km = torch.from_numpy(rng.integers(0, 300, size=(4, 256)).astype(np.int32))

    def launch():
        t = ttk.make_table(1024, max_groups=512)
        tickets, _ = tfk.scan_ticket_plain(t, km, torch.ones(4, dtype=torch.int32),
                                           checked=True, threshold=512)
        return tickets, t

    ref = launch()
    assert tfk.scan_ticket_discrepancies(km, launch(), ref) == 0
    tickets, t = launch()
    n = int(t.count)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    occ = t.tickets > 0
    renum = ttk.TicketTable(t.keys, torch.where(occ, perm[(t.tickets - 1).clamp(min=0).long()] + 1,
                                                t.tickets),
                            t.key_by_ticket.clone(), t.count, t.overflowed)
    renum.key_by_ticket[perm.long()] = t.key_by_ticket[:n]
    assert tfk.scan_ticket_discrepancies(km, (perm[tickets.long()], renum), ref) == 0
    bad = tickets.clone()
    bad[0, 0] = (bad[0, 0] + 1) % n
    assert tfk.scan_ticket_discrepancies(km, (bad, t), ref) > 0


@pytest.mark.parametrize("kernel", ["off", "scan_body"])
def test_zero_row_and_short_chunks(kernel):
    """Chunks with no rows and chunks shorter than a morsel, as the JAX
    plan takes them."""
    jp, tp, names = _plan_pair(64, "raise", kernel)
    keys = np.arange(10, dtype=np.uint32)
    vals = np.arange(10, dtype=np.float32)
    parts = [(keys[:0], vals[:0]), (keys, vals), (keys[:0], vals[:0])]
    jout = jp.collect([JTable({"k": jnp.asarray(k), "v": jnp.asarray(v)}) for k, v in parts])
    tout = tp.collect([TTable({"k": _tt(k), "v": _tt(v)}) for k, v in parts])
    assert int(tout["__num_groups__"][0]) == 10
    _assert_results_equal(jout, tout, names, keys, vals)
