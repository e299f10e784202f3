"""The split kernel route of repro_torch (``kernel="split"``) vs the JAX
reference, on the CPU (the kernels' plain versions).

The plain ticket kernel must match ``ticket_hash_pallas(interpret=True)``
ticket for ticket (tickets, table, key_by_ticket, count); the plain segment
kernel matches ``segment_agg_pallas(interpret=True)`` with COUNT/MIN/MAX
exact and SUM within rtol 1e-6 / atol 1e-5 (the same adds, possibly in
another order).  The ops wrappers, ``core.updates`` and whole
``kernel="split"`` plans are held to their reference counterparts.  The
CUDA kernels are held to the plain versions on a card, in
tests/test_torch_gpu.py."""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import updates as jup
from repro.engine import executors as jex
from repro.engine import plan_api as japi
from repro.kernels import ops as jops
from repro.kernels.segment_agg import segment_agg_pallas
from repro.kernels.ticket_hash import ticket_hash_pallas
from repro_torch.core import updates as tup
from repro_torch.engine import columns as tcol
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.groupby import GroupByOverflowError as TOverflow
from repro.engine.groupby import GroupByOverflowError as JOverflow
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_agg as tsa
from repro_torch.kernels import ticket_hash as tth

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

SUM_RTOL, SUM_ATOL = 1e-6, 1e-5
EMPTY_U32 = 0xFFFFFFFF
KINDS = ("sum", "count", "min", "max")


def _i32(a) -> np.ndarray:
    """JAX int32/uint32 array → int32 bit patterns."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# -- ticket kernel -----------------------------------------------------------

TICKET_CASES = {
    # name: (rows, morsel, key cardinality, capacity, max_groups)
    "small": (1024, 256, 64, 256, 128),
    "medium": (2048, 512, 500, 1024, 512),
    "unique": (4096, 1024, 1 << 30, 8192, 4096),
    "one_morsel": (1024, 1024, 8, 16, 8),
    "heavy_hitter": (2048, 512, 300, 1024, 512),
    "count_over_bound": (2048, 512, 500, 1024, 128),
    "full_table": (1024, 256, 1000, 256, 256),
    "empty_padding": (2048, 256, 400, 1024, 512),
}


def _ticket_keys(name, rows, card, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, card, size=rows).astype(np.uint32)
    if name == "heavy_hitter":
        keys[rng.random(rows) < 0.5] = 7
    if name == "empty_padding":
        keys[rng.choice(rows, rows // 8, replace=False)] = EMPTY_U32
        keys[-300:] = EMPTY_U32
    return keys


@pytest.mark.parametrize("name", sorted(TICKET_CASES))
def test_ticket_plain_matches_pallas_ticket_for_ticket(name):
    rows, morsel, card, cap, g = TICKET_CASES[name]
    keys = _ticket_keys(name, rows, card, sorted(TICKET_CASES).index(name))
    want = ticket_hash_pallas(jnp.asarray(keys), capacity=cap, max_groups=g,
                              morsel_size=morsel, interpret=True)
    got = tth.ticket_hash(_t(keys.view(np.int32)), capacity=cap, max_groups=g,
                          morsel_size=morsel)
    for label, w, t in zip(("tickets", "table_keys", "table_tickets", "key_by_ticket",
                            "count"), want, got):
        assert t.dtype == torch.int32, label
        assert np.array_equal(t.numpy(), _i32(w)), label
    count = int(got[4])
    distinct = np.unique(keys[keys != EMPTY_U32]).size
    if name == "full_table":
        assert count == cap and bool((got[0] < 0).any())
    else:
        assert count == distinct
        assert bool(((got[0] < 0) == _t(keys == EMPTY_U32)).all())
    if name == "count_over_bound":
        assert count > g and int(got[0].max()) == count - 1


def test_ticket_hash_checks_its_arguments():
    keys = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(ValueError, match="morsel_size"):
        tth.ticket_hash(keys, capacity=256, max_groups=64, morsel_size=256)
    with pytest.raises(ValueError, match="power of 2"):
        tth.ticket_hash(keys[:768], capacity=300, max_groups=64, morsel_size=256)
    # meta tensors (the dry run, launch/dryrun.py) get the outputs' shapes
    # and dtypes, and nothing is launched
    got = tth.ticket_hash(keys[:768].to("meta"), capacity=256, max_groups=64, morsel_size=256)
    want = tth.ticket_hash_plain(keys[:768], capacity=256, max_groups=64, morsel_size=256)
    assert [(t.device.type, t.shape, t.dtype) for t in got] == \
        [("meta", t.shape, t.dtype) for t in want]
    assert tth.ticket_hash.launches == 0


# -- the ticket-map checker (the kernel's contract with the plain version) ----


def _plain_case(name):
    rows, morsel, card, cap, g = TICKET_CASES[name]
    keys = _t(_ticket_keys(name, rows, card, 5).view(np.int32))
    return keys, tth.ticket_hash_plain(keys, capacity=cap, max_groups=g,
                                       morsel_size=morsel)


def _renumbered(out, new_of):
    """``out`` with ticket t (1-based) renamed ``new_of[t - 1]`` in the
    table, the rows and ``key_by_ticket``, as a racing kernel may number
    them."""
    tickets, tkeys, ttks, kbt, count = (x.clone() for x in out)
    occ = ttks > 0
    ttks[occ] = new_of[ttks[occ].long() - 1]
    ok = tickets >= 0
    tickets[ok] = new_of[tickets[ok].long()] - 1
    kbt.fill_(-1)
    inb = occ & (ttks <= kbt.numel())
    kbt[ttks[inb].long() - 1] = tkeys[inb]
    return tickets, tkeys, ttks, kbt, count


@pytest.mark.parametrize("name", ["medium", "heavy_hitter", "count_over_bound",
                                  "empty_padding", "full_table"])
def test_ticket_map_checker_accepts_any_numbering(name):
    keys, ref = _plain_case(name)
    n = int(ref[4])
    full = name == "full_table"
    assert tth.ticket_map_discrepancies(keys, ref, ref, full=full) == 0
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(n)).to(torch.int32) + 1
    assert tth.ticket_map_discrepancies(keys, _renumbered(ref, perm), ref, full=full) == 0


def _corrupt(out, how):
    tickets, tkeys, ttks, kbt, count = (x.clone() for x in out)
    n = int(count)
    if how == "gap":  # ticket 3 never issued: every later ticket one up
        out = _renumbered(out, torch.arange(1, n + 1, dtype=torch.int32)
                          + (torch.arange(1, n + 1) >= 3).to(torch.int32))
        return out
    if how == "duplicate":  # two slots share ticket 1
        ttks[torch.nonzero(ttks == 2)[0]] = 1
    elif how == "key_by_ticket":  # ticket 1 names ticket 2's key
        kbt[0] = kbt[1]
    elif how == "dropped_row":  # a resolved row left -1, the table had room
        tickets[torch.nonzero(tickets >= 0)[7]] = -1
    elif how == "count":
        count = count + 1
    return tickets, tkeys, ttks, kbt, count


@pytest.mark.parametrize("how", ["gap", "duplicate", "key_by_ticket", "dropped_row",
                                 "count"])
def test_ticket_map_checker_counts_each_corruption(how):
    keys, ref = _plain_case("medium")
    assert int(ref[4]) <= TICKET_CASES["medium"][4]
    assert tth.ticket_map_discrepancies(keys, _corrupt(ref, how), ref) > 0


# -- segment kernel ----------------------------------------------------------


def _segment_inputs(seed, n, g, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tickets = rng.integers(-1, g + 40, size=n).astype(np.int32)  # -1 and >= g mixed in
    vals = rng.normal(size=n) * 4
    if np.issubdtype(dtype, np.integer):
        vals = np.round(vals)
    return tickets, vals.astype(dtype)


def _assert_acc(kind, got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if kind == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL, atol=SUM_ATOL)
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("strategy", ["scatter", "onehot"])
@pytest.mark.parametrize("kind", KINDS)
def test_segment_plain_matches_pallas(kind, strategy):
    t, v = _segment_inputs(KINDS.index(kind), 2048, 300)
    want = segment_agg_pallas(jnp.asarray(t), jnp.asarray(v), num_groups=300, kind=kind,
                              strategy=strategy, morsel_size=512, interpret=True)
    got = tsa.segment_agg(_t(t), _t(v), num_groups=300, kind=kind, strategy=strategy,
                          morsel_size=512)
    _assert_acc(kind, got, want)


@pytest.mark.parametrize("dtype", [np.float16, np.int32, np.float64])
@pytest.mark.parametrize("kind", ["sum", "max"])
def test_segment_plain_value_dtypes(kind, dtype):
    t, v = _segment_inputs(5, 1024, 100, dtype)
    want = segment_agg_pallas(jnp.asarray(t), jnp.asarray(v.astype(np.float32)),
                              num_groups=100, kind=kind, morsel_size=256, interpret=True)
    got = tsa.segment_agg(_t(t), _t(v), num_groups=100, kind=kind, morsel_size=256)
    _assert_acc(kind, got, want)


def test_onehot_above_shared_memory_limit_raises():
    t = torch.zeros(1024, dtype=torch.int32)
    v = torch.ones(1024)
    with pytest.raises(ValueError, match="MAX_ONEHOT_GROUPS"):
        tsa.segment_agg(t, v, num_groups=tsa.MAX_ONEHOT_GROUPS + 1, strategy="onehot")
    ok = tsa.segment_agg(t, v, num_groups=tsa.MAX_ONEHOT_GROUPS, strategy="onehot")
    assert float(ok[0]) == 1024.0
    with pytest.raises(ValueError, match="strategy"):
        tsa.segment_agg(t, v, num_groups=8, strategy="sort_segment")


# -- ops wrappers ------------------------------------------------------------


@pytest.mark.parametrize("n,morsel", [(1000, 256), (4096, 1024)])
def test_ops_ticket_matches_reference(n, morsel):
    keys = np.random.default_rng(n).integers(0, 700, size=n).astype(np.uint32)
    tt, tk_, tc = tops._ticket(_t(keys.astype(np.int64)), capacity=2048, max_groups=1024,
                               morsel_size=morsel)
    jt, jk, jc = jops._ticket(jnp.asarray(keys), capacity=2048, max_groups=1024,
                              morsel_size=morsel, interpret=True)
    assert tt.shape == (n,)
    assert np.array_equal(tt.numpy(), _i32(jt))
    assert np.array_equal(tk_.numpy(), _i32(jk))
    assert int(tc) == int(jc) == np.unique(keys).size


@pytest.mark.parametrize("strategy", ["scatter", "onehot"])
@pytest.mark.parametrize("kind", KINDS)
def test_ops_segment_aggregate_matches_reference(kind, strategy):
    t, v = _segment_inputs(11 + KINDS.index(kind), 1000, 200)  # 1000 % 256 != 0: padded
    got = tops._segment_aggregate(_t(t), _t(v), num_groups=200, kind=kind,
                                  strategy=strategy, morsel_size=256)
    want = jops._segment_aggregate(jnp.asarray(t), jnp.asarray(v), num_groups=200,
                                   kind=kind, strategy=strategy, morsel_size=256,
                                   interpret=True)
    _assert_acc(kind, got, want)


def test_multi_block_ticket_matches_reference():
    keys = np.random.default_rng(21).integers(0, 3000, size=4096).astype(np.uint32)
    kw = dict(blocks=4, capacity_per_block=2048, max_groups_per_block=1024,
              morsel_size=1024)
    tt, tk_, tc = tops.multi_block_ticket(_t(keys.astype(np.int64)), **kw)
    jt, jk, jc = jops.multi_block_ticket(jnp.asarray(keys), interpret=True, **kw)
    assert np.array_equal(tt.numpy(), _i32(jt))
    assert np.array_equal(tk_.numpy(), _i32(jk))
    assert np.array_equal(tc.numpy(), _i32(jc))
    assert int(tc.sum()) == np.unique(keys).size


@pytest.mark.parametrize("kind", KINDS)
def test_make_scan_update_fn_matches_reference(kind):
    rng = np.random.default_rng(31 + KINDS.index(kind))
    acc0 = (rng.normal(size=128) * 3).astype(np.float32)
    t, v = _segment_inputs(41, 512, 128)
    tfn = tops.make_scan_update_fn(strategy="scatter", morsel_size=256)
    assert tfn is tops.make_scan_update_fn(strategy="scatter", morsel_size=256)
    jfn = jops.make_scan_update_fn(strategy="scatter", morsel_size=256, interpret=True)
    got = tfn(_t(acc0.copy()), _t(t), _t(v), kind=kind)  # folds in place
    want = jfn(jnp.asarray(acc0), jnp.asarray(t), jnp.asarray(v), kind=kind)
    _assert_acc(kind, got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_scatter_update_and_init_acc_match_reference(kind):
    rng = np.random.default_rng(51 + KINDS.index(kind))
    g = 64
    t = rng.integers(-1, g, size=700).astype(np.int32)
    v = rng.normal(size=700).astype(np.float32)
    acc = tup.init_acc(g, kind)
    jacc = jup.init_acc(g, kind)
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert float(tup.neutral(kind)) == float(jup.neutral(kind))
    for _ in range(2):  # fold twice: into the neutral, then into a live acc
        acc = tup.scatter_update(acc, _t(t), _t(v), kind=kind)
        jacc = jup.scatter_update(jacc, jnp.asarray(t), jnp.asarray(v), kind=kind)
    _assert_acc(kind, acc, jacc)
    if kind == "count":  # count reads ones, which the reference cannot widen
        return
    v2 = rng.normal(size=(700, 3)).astype(np.float32)
    got2 = tup.scatter_update(tup.init_acc(g, kind, width=3), _t(t), _t(v2), kind=kind)
    want2 = jup.scatter_update(jup.init_acc(g, kind, width=3), jnp.asarray(t),
                               jnp.asarray(v2), kind=kind)
    _assert_acc(kind, got2, want2)


# -- the slice as a whole: kernel="split" plans ------------------------------

AGGS = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"))  # as chip_smoke.py


def _plans(max_groups, saturation, **ex):
    ex = dict(morsel_size=512, **ex)
    tplan = tapi.GroupByPlan(
        keys=("__key__",), aggs=tuple(tapi.AggSpec(k, c) for k, c in AGGS),
        strategy="concurrent", max_groups=max_groups, saturation=saturation,
        raw_keys=True, execution=tapi.ExecutionPolicy(kernel="split", device="cpu", **ex))
    jplan = japi.GroupByPlan(
        keys=("__key__",), aggs=tuple(japi.AggSpec(k, c) for k, c in AGGS),
        strategy="concurrent", max_groups=max_groups, saturation=saturation,
        raw_keys=True, execution=japi.ExecutionPolicy(kernel="split", **ex))
    return tplan, jplan


def _chunks(keys, vals, n_chunks):
    rows = -(-keys.shape[0] // n_chunks)
    return [(keys[lo:lo + rows], vals[lo:lo + rows]) for lo in range(0, keys.shape[0], rows)]


def _run_split(keys, vals, n_chunks, max_groups, saturation, **ex):
    tplan, jplan = _plans(max_groups, saturation, **ex)
    parts = _chunks(keys, vals, n_chunks)
    handle = tplan.stream([tcol.Table({"__key__": _t(k.astype(np.int64)), "v": _t(v)})
                           for k, v in parts])
    tout = handle.result()
    jout = jplan.collect([japi.arrays_as_table(jnp.asarray(k), jnp.asarray(v))[0]
                          for k, v in parts])
    return tout, jout, handle


def _result_map(out, col):
    n = int(np.asarray(out["__num_groups__"])[0])
    keys = np.asarray(out["key"])[:n].astype(np.int64)
    return dict(zip(keys.tolist(), np.asarray(out[col])[:n].tolist()))


def _assert_results_agree(tout, jout, *, row_order):
    n = int(np.asarray(jout["__num_groups__"])[0])
    assert int(tout["__num_groups__"][0]) == n
    for kind, col in AGGS:
        name = f"{kind}({col or '*'})"
        got, want = _result_map(tout, name), _result_map(jout, name)
        assert got.keys() == want.keys(), name
        for k, w in want.items():
            g = got[k]
            if kind in ("sum", "mean"):
                assert abs(g - w) <= SUM_ATOL + SUM_RTOL * abs(w), (name, k)
            else:
                assert g == w or (np.isnan(g) and np.isnan(w)), (name, k)
    if row_order:
        assert np.array_equal(tout["key"].numpy()[:n],
                              np.asarray(jout["key"])[:n].astype(np.int64))
        assert np.array_equal(tout["count(*)"].numpy()[:n], np.asarray(jout["count(*)"])[:n])
        assert np.array_equal(tout["max(v)"].numpy()[:n], np.asarray(jout["max(v)"])[:n])


def _stream_data(seed, rows=4096, card=400, masked=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, card, size=rows).astype(np.uint32)
    if masked:
        keys[rng.choice(rows, masked, replace=False)] = EMPTY_U32
    return keys, rng.normal(size=rows).astype(np.float32)


SPLIT_CASES = {
    # name: (saturation, max_groups, execution overrides, key cardinality)
    "raise": ("raise", 512, {}, 400),
    "raise_onehot": ("raise", 512, dict(update="onehot"), 400),
    "grow_bound": ("grow", 64, {}, 400),
    "grow_capacity": ("grow", 512, dict(capacity=128), 400),
    "unchecked": ("unchecked", 512, {}, 400),
    "unchecked_truncates": ("unchecked", 128, {}, 200),  # count > bound
}


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plan_matches_reference(case, n_chunks):
    saturation, bound, ex, card = SPLIT_CASES[case]
    keys, vals = _stream_data(sorted(SPLIT_CASES).index(case), card=card, masked=100)
    tout, jout, handle = _run_split(keys, vals, n_chunks, bound, saturation, **ex)
    _assert_results_agree(tout, jout, row_order=n_chunks == 1)
    stats = handle.stats()
    assert stats["strategy"] == "pallas"
    assert stats["device"]["device_table_bytes"] > 0
    ex_ = handle.executor
    if saturation == "grow":
        assert ex_.relaunches >= 1
        assert (ex_.bound_grows if case == "grow_bound" else ex_.capacity_grows) >= 1
    if n_chunks == 1:
        assert stats["peak_retained_bytes"] > 0  # the held first partial
    if case != "unchecked_truncates":
        live = keys != EMPTY_U32
        uk, cnt = np.unique(keys[live], return_counts=True)
        assert _result_map(tout, "count(*)") == dict(zip(uk.tolist(), cnt.astype(float)))


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_split_overflow_raises_like_reference(n_chunks):
    keys, vals = _stream_data(61, rows=4096, card=200)  # count > bound, table not full
    tplan, jplan = _plans(128, "raise")
    parts = _chunks(keys, vals, n_chunks)
    with pytest.raises(TOverflow):
        tplan.collect([tcol.Table({"__key__": _t(k.astype(np.int64)), "v": _t(v)})
                       for k, v in parts])
    with pytest.raises(JOverflow):
        jplan.collect([japi.arrays_as_table(jnp.asarray(k), jnp.asarray(v))[0]
                       for k, v in parts])


def test_split_update_strategy_is_validated():
    for bad in ("sort_segment", "bogus"):
        tplan, _ = _plans(64, "raise", update=bad)
        with pytest.raises(ValueError, match="update"):
            tex.make_executor(tplan)
    for update in (None, "scatter", "onehot"):
        tplan, _ = _plans(64, "raise", update=update)
        assert isinstance(tex.make_executor(tplan), tex._PallasExecutor)


def test_next_bound_matches_reference():
    for args in ((64, 10_000), (4000, 10_000), (64, 10_000, 9000), (16, 50, 70)):
        assert tex._next_bound(*args) == jex._next_bound(*args)
    assert tex._MERGE_KIND == jex._MERGE_KIND


# -- deprecation shims -------------------------------------------------------


def test_strategy_pallas_alias_warns_once_and_matches():
    keys, vals = _stream_data(71, rows=4096, card=200)
    table = tapi.arrays_as_table(_t(keys.astype(np.int64)), _t(vals))[0]

    def run(**kw):
        plan = tapi.GroupByPlan(
            keys=("__key__",), aggs=(tapi.AggSpec("sum", "v"),), max_groups=256,
            raw_keys=True, **kw)
        return tapi.execute(plan, table)

    tex.reset_kernel_alias_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = run(strategy="pallas", execution=tapi.ExecutionPolicy(device="cpu"))
        run(strategy="pallas", execution=tapi.ExecutionPolicy(device="cpu"))
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "kernel='split'" in str(dep[0].message)
    new = run(strategy="concurrent",
              execution=tapi.ExecutionPolicy(kernel="split", device="cpu"))
    assert int(old["__num_groups__"][0]) == int(new["__num_groups__"][0])
    assert _result_map(old, "sum(v)") == _result_map(new, "sum(v)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ex = tex.make_executor(tapi.GroupByPlan(
            keys=("k",), aggs=(tapi.AggSpec("count"),), strategy="concurrent",
            max_groups=64, execution=tapi.ExecutionPolicy(use_kernel=True, device="cpu")))
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "kernel='scan_body'" in str(dep[0].message)
    assert isinstance(ex, tex._ScanExecutor) and ex._op.use_kernel  # the scan_body route


def test_direct_entry_points_warn_once():
    keys = _t(np.random.default_rng(81).integers(0, 64, size=1024))
    tops.reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tops.ticket(keys, capacity=256, max_groups=128)
        tops.ticket(keys, capacity=256, max_groups=128)
        tops.segment_aggregate(torch.zeros(1024, dtype=torch.int32), torch.ones(1024),
                               num_groups=8)
        tops.groupby_pallas(keys, kind="count", max_groups=128, device="cpu")
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 3  # one per alias, not per call
    assert all("ExecutionPolicy.kernel" in str(w.message) for w in dep)


def test_groupby_pallas_matches_reference():
    keys, vals = _stream_data(91, rows=4096, card=400)
    tk_, ta, tn = tops.groupby_pallas(_t(keys.astype(np.int64)), _t(vals), kind="sum",
                                      max_groups=512, morsel_size=512, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jk, ja, jn = jops.groupby_pallas(jnp.asarray(keys), jnp.asarray(vals), kind="sum",
                                         max_groups=512, morsel_size=512)
    n = int(jn)
    assert int(tn) == n
    assert np.array_equal(tk_.numpy()[:n], np.asarray(jk)[:n].astype(np.int64))
    np.testing.assert_allclose(ta.numpy()[:n], np.asarray(ja)[:n], rtol=SUM_RTOL,
                               atol=SUM_ATOL)
