"""The repro_torch plan API on the fused route (``device="cpu"``, the
kernel's plain path) vs the JAX package, mirroring the fused cases of
tests/test_kernels.py: results compared as key→value maps against JAX
``kernel="fused"`` and ``kernel="off"``, and — since the plain path tickets
exactly like the Pallas kernel — column for column against JAX fused."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engine import columns as jcol
from repro.engine import plan_api as japi
from repro.kernels import ops as jops
from repro.obs import metrics as jmet
from repro_torch.data import pipeline as tpipe
from repro_torch.engine import columns as tcol
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.groupby import GroupByOverflowError
from repro_torch.kernels import fused_groupby as tfk
from repro_torch.kernels import ops as tops

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

TOL = 1e-4


def _keys_for(dist, n, card, rng):
    if dist == "uniform":
        return rng.integers(0, card, size=n).astype(np.uint32)
    if dist == "zipf":
        return (rng.zipf(1.3, size=n) % card).astype(np.uint32)
    return rng.choice(n, size=n, replace=True).astype(np.uint32)


def _jax_plan(aggs, **kw):
    ex = dict(morsel_size=512)
    ex.update(kw.pop("execution", {}))
    return japi.GroupByPlan(
        keys=("__key__",), aggs=tuple(japi.AggSpec(a.kind, a.column) for a in aggs),
        strategy="concurrent", max_groups=kw.pop("max_groups", 1024),
        saturation=kw.pop("saturation", "raise"), raw_keys=True,
        execution=japi.ExecutionPolicy(**ex),
    )


def _torch_plan(aggs, **kw):
    ex = dict(morsel_size=512, kernel="fused", device="cpu")
    ex.update(kw.pop("execution", {}))
    return tapi.GroupByPlan(
        keys=("__key__",), aggs=tuple(aggs), strategy="concurrent",
        max_groups=kw.pop("max_groups", 1024),
        saturation=kw.pop("saturation", "raise"), raw_keys=True,
        execution=tapi.ExecutionPolicy(**ex),
    )


def _run_jax(keys, vals, aggs, **kw):
    table, _ = japi.arrays_as_table(jnp.asarray(keys), jnp.asarray(vals))
    return japi.execute(_jax_plan(aggs, **kw), table)


def _run_torch(keys, vals, aggs, **kw):
    table, _ = tapi.arrays_as_table(torch.from_numpy(keys.astype(np.int64)),
                                    torch.from_numpy(vals))
    return tapi.execute(_torch_plan(aggs, **kw), table)


def _map(out, col):
    n = int(np.asarray(out["__num_groups__"])[0])
    keys = np.asarray(out["key"])[:n].astype(np.int64)
    return dict(zip(keys.tolist(), np.asarray(out[col])[:n].tolist()))


def _assert_maps_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= TOL * max(1.0, abs(w)), k


def _np_sums(keys, vals):
    """numpy oracle: key → float64 sum."""
    uk, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(uk.size)
    np.add.at(sums, inv, vals.astype(np.float64))
    return dict(zip(uk.astype(np.int64).tolist(), sums.tolist()))


def _assert_same_columns(tout, jout, cols):
    """Port ≡ JAX fused: same ticket order, same values (floats to 1e-6)."""
    n = int(np.asarray(jout["__num_groups__"])[0])
    assert int(tout["__num_groups__"][0]) == n
    assert np.array_equal(tout["key"].numpy()[:n], np.asarray(jout["key"])[:n].astype(np.int64))
    for c in cols:
        np.testing.assert_allclose(tout[c].numpy()[:n], np.asarray(jout[c])[:n],
                                   rtol=1e-6, atol=1e-6)


MATRIX_AGGS = (tapi.AggSpec("sum", "v"), tapi.AggSpec("count"), tapi.AggSpec("min", "v"),
               tapi.AggSpec("max", "v"), tapi.AggSpec("mean", "v"))


@functools.lru_cache(maxsize=None)
def _matrix_runs(dist):
    """One 5-aggregate plan per distribution, run by the port and by JAX
    (fused and off): every cell of the matrix reads its column from it."""
    rng = np.random.default_rng(["uniform", "zipf", "near_unique"].index(dist))
    n = 4096
    keys = _keys_for(dist, n, 300, rng)
    vals = rng.normal(size=n).astype(np.float32)
    got = _run_torch(keys, vals, MATRIX_AGGS, max_groups=4096)
    fused = _run_jax(keys, vals, MATRIX_AGGS, max_groups=4096,
                     execution=dict(kernel="fused"))
    off = _run_jax(keys, vals, MATRIX_AGGS, max_groups=4096, execution=dict(kernel="off"))
    return got, fused, off


@pytest.mark.parametrize("dist", ["uniform", "zipf", "near_unique"])
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max", "mean"])
def test_fused_plan_parity_matrix(dist, kind):
    got, fused, off = _matrix_runs(dist)
    name = next(a.name for a in MATRIX_AGGS if a.kind == kind)
    _assert_same_columns(got, fused, (name,))
    _assert_maps_close(_map(got, name), _map(off, name))


def _chunks_of(keys, vals, rows):
    for lo in range(0, keys.shape[0], rows):
        yield tcol.Table({"__key__": torch.from_numpy(keys[lo:lo + rows].astype(np.int64)),
                          "v": torch.from_numpy(vals[lo:lo + rows])})


def test_streaming_equals_oneshot_bit_exact():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 400, size=8192).astype(np.uint32)
    vals = rng.normal(size=8192).astype(np.float32)
    aggs = (tapi.AggSpec("sum", "v"), tapi.AggSpec("mean", "v"), tapi.AggSpec("max", "v"))
    plan = _torch_plan(aggs, max_groups=512)
    oneshot = plan.collect(next(_chunks_of(keys, vals, 8192)))
    streamed = plan.collect(tpipe.IterableSource(list(_chunks_of(keys, vals, 2048))))
    n = int(oneshot["__num_groups__"][0])
    assert n == int(streamed["__num_groups__"][0]) == np.unique(keys).size
    for col in ("key", "sum(v)", "mean(v)", "max(v)"):
        assert torch.equal(oneshot[col][:n], streamed[col][:n]), col


@functools.lru_cache(maxsize=None)
def _grow_runs():
    """One undersized GROW stream (3 chunks, masked rows, instrumented),
    run by the port and by JAX fused: shared by the grow and stats tests."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 200, size=6000).astype(np.uint32)
    keys[:100] = 0xFFFFFFFF
    vals = rng.normal(size=6000).astype(np.float32)
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("sum", "v"))
    kw = dict(max_groups=64, saturation="grow")
    tplan = _torch_plan(aggs, execution=dict(capacity=64, instrument=True), **kw)
    jplan = _jax_plan(aggs, execution=dict(kernel="fused", capacity=64, instrument=True),
                      **kw)
    th = tplan.stream(_chunks_of(keys, vals, 2000))
    tout = th.result()
    jchunks = [japi.arrays_as_table(jnp.asarray(keys[lo:lo + 2000]),
                                    jnp.asarray(vals[lo:lo + 2000]))[0]
               for lo in range(0, 6000, 2000)]
    jh = jplan.stream(jchunks)
    jout = jh.result()
    return keys, vals, tout, jout, th.stats()["device"], jh.stats()["device"]


def test_grow_recovers_undersized_bound():
    keys, vals, tout, jout, tdev, _ = _grow_runs()
    _assert_same_columns(tout, jout, ("count(*)", "sum(v)"))
    live = keys != 0xFFFFFFFF
    _assert_maps_close(_map(tout, "sum(v)"), _np_sums(keys[live], vals[live]))
    assert tdev["bound_grows"] >= 1 and tdev["migrations"] >= 1


def test_grow_under_prefetch_replays_every_pending_launch():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 600, size=8192).astype(np.uint32)
    vals = np.ones(8192, dtype=np.float32)
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("sum", "v"))
    plan = _torch_plan(aggs, max_groups=64, saturation="grow",
                       execution=dict(morsel_size=1024, instrument=True))
    handle = plan.stream(_chunks_of(keys, vals, 1024))
    out = handle.result()
    ref_k, ref_c = np.unique(keys, return_counts=True)
    assert int(out["__num_groups__"][0]) == ref_k.size
    assert {k: int(v) for k, v in _map(out, "count(*)").items()} == dict(
        zip(ref_k.tolist(), ref_c.tolist()))
    assert _map(out, "sum(v)") == _map(out, "count(*)")
    dev = handle.stats()["device"]
    assert dev["bound_grows"] >= 2 and dev["rows"] == 8192


def _racing_kernel(monkeypatch, seed):
    """Replace the fused kernel with a stand-in for CTAs that race: each
    launch commits a random, non-empty subset of every program's todo
    morsels (through the plain version, in order) and pauses the rest
    although the table has room.  Returns its log: one (count, bound) pair
    per program and launch, read after the launch."""
    plain = tfk.fused_consume_plain
    rng = np.random.default_rng(seed)
    log = []

    def stand_in(state, keys, values, todo, **kw):
        P = state.programs
        flags = todo.reshape(P, -1)
        sub = torch.zeros_like(flags)
        for p in range(P):
            idx = torch.nonzero(flags[p]).flatten()
            if idx.numel():
                pick = torch.from_numpy(rng.random(idx.numel()) < 0.5)
                pick[int(rng.integers(idx.numel()))] = True
                sub[p, idx[pick]] = 1
        chosen = sub.clone()
        state, info = plain(state, keys, values, sub.reshape(-1), **kw)
        flags[(chosen == 1) & (sub == 0)] = 0  # the committed morsels
        for p in range(P):
            left = torch.nonzero(flags[p]).flatten()
            info[p, tfk.INFO_FIRST_HALT] = int(left[0]) if left.numel() else tfk.NO_HALT
            info[p, tfk.INFO_HALTED] = int(left.numel() > 0)
            log.append((int(state.count[p]), state.max_groups))
        return state, info

    monkeypatch.setattr(tfk, "fused_consume", stand_in)
    return log


@pytest.mark.parametrize("programs", [1, 2])
def test_racing_commits_give_the_jax_result_without_growth(monkeypatch, programs):
    """GROW launches that pause morsels while room remains (the bound's
    reservation race; under RAISE the kernel pauses only past the load
    threshold) are replayed on their todo masks with no grow: the JAX
    fused plan's map, no bound grows or migrations (the plain path's and
    JAX's 0 and 0)."""
    saturation = "grow"
    rng = np.random.default_rng(20 + programs)
    keys = rng.integers(0, 300, size=8192).astype(np.uint32)
    vals = rng.normal(size=8192).astype(np.float32)
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("sum", "v"), tapi.AggSpec("min", "v"))
    kw = dict(max_groups=1024, saturation=saturation)
    want = _run_jax(keys, vals, aggs, execution=dict(kernel="fused"), **kw)
    log = _racing_kernel(monkeypatch, programs)
    plan = _torch_plan(aggs, execution=dict(kernel_programs=programs, instrument=True), **kw)
    handle = plan.stream(_chunks_of(keys, vals, 2048))
    got = handle.result()
    for col in ("count(*)", "sum(v)", "min(v)"):
        _assert_maps_close(_map(got, col), _map(want, col))
    dev = handle.stats()["device"]
    assert dev["bound_grows"] == 0 and dev["migrations"] == 0
    assert dev["rows"] == 8192
    assert len(log) > 4 * programs  # more launches than chunks: paused morsels replayed


def test_racing_commits_under_a_tight_grow_bound_issue_no_ticket_past_it(monkeypatch):
    rng = np.random.default_rng(23)
    keys = rng.integers(0, 600, size=8192).astype(np.uint32)
    vals = rng.normal(size=8192).astype(np.float32)
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("max", "v"))
    kw = dict(max_groups=64, saturation="grow")
    want = _run_jax(keys, vals, aggs, execution=dict(kernel="fused"), **kw)
    log = _racing_kernel(monkeypatch, 3)
    plan = _torch_plan(aggs, execution=dict(instrument=True), **kw)
    handle = plan.stream(_chunks_of(keys, vals, 2048))
    got = handle.result()
    for col in ("count(*)", "max(v)"):
        _assert_maps_close(_map(got, col), _map(want, col))
    assert all(count <= bound for count, bound in log), log
    assert handle.stats()["device"]["bound_grows"] >= 1


def test_overflow_raises():
    keys = np.arange(2048, dtype=np.uint32)
    vals = np.ones(2048, dtype=np.float32)
    with pytest.raises(GroupByOverflowError):
        _run_torch(keys, vals, (tapi.AggSpec("sum", "v"),), max_groups=64)


def test_unchecked_saturation_drops_like_jax():
    keys = np.arange(2048, dtype=np.uint32)
    vals = np.ones(2048, dtype=np.float32)
    agg = (tapi.AggSpec("sum", "v"),)
    kw = dict(max_groups=64, saturation="unchecked")
    got = _run_torch(keys, vals, agg, **kw)
    want = _run_jax(keys, vals, agg, execution=dict(kernel="fused"), **kw)
    assert int(got["__num_groups__"][0]) == int(np.asarray(want["__num_groups__"])[0])
    assert np.array_equal(got["key"].numpy(), np.asarray(want["key"]).astype(np.int64))


def test_programs_4_merge():
    """P = 4 local tables + second-level merge give the P = 1 map."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 300, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    aggs = (tapi.AggSpec("sum", "v"), tapi.AggSpec("min", "v"))
    got = _run_torch(keys, vals, aggs, execution=dict(kernel_programs=4))
    one = _run_torch(keys, vals, aggs)
    _assert_maps_close(_map(got, "sum(v)"), _np_sums(keys, vals))
    assert _map(got, "min(v)") == _map(one, "min(v)")
    # the P-program merge itself is held to JAX bit for bit in
    # test_torch_fused.py::test_init_grow_merge_state_match_jax


def test_two_key_plan_with_mask():
    rng = np.random.default_rng(7)
    n = 4096
    a = rng.integers(0, 40, size=n).astype(np.uint32)
    b = rng.integers(0, 9, size=n).astype(np.uint32)
    v = rng.normal(size=n).astype(np.float32)
    mask = v > -0.5
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("mean", "v"), tapi.AggSpec("max", "v"))
    tplan = tapi.GroupByPlan(
        keys=("a", "b"), aggs=aggs, strategy="concurrent", max_groups=512,
        execution=tapi.ExecutionPolicy(kernel="fused", morsel_size=512, device="cpu"))
    jplan = japi.GroupByPlan(
        keys=("a", "b"), aggs=tuple(japi.AggSpec(x.kind, x.column) for x in aggs),
        strategy="concurrent", max_groups=512,
        execution=japi.ExecutionPolicy(kernel="off"))
    got = tplan.run(tcol.Table({"a": torch.from_numpy(a.astype(np.int64)),
                                "b": torch.from_numpy(b.astype(np.int64)),
                                "v": torch.from_numpy(v),
                                "__mask__": torch.from_numpy(mask)}))
    want = jplan.run(jcol.Table({"a": jnp.asarray(a), "b": jnp.asarray(b),
                                 "v": jnp.asarray(v), "__mask__": jnp.asarray(mask)}))
    for col in ("count(*)", "mean(v)", "max(v)"):
        _assert_maps_close(_map(got, col), _map(want, col))
    assert sum(_map(got, "count(*)").values()) == int(mask.sum())


def test_stats_event_counts_equal_jax():
    _, _, _, _, tdev, jdev = _grow_runs()
    for key in ("morsels", "rows", "rows_masked", "probe_steps", "probe_saturations",
                "pauses", "probe_hist", "migrations", "bound_grows", "num_groups",
                "table_capacity", "device_table_bytes"):
        assert tdev[key] == jdev[key], key
    assert tdev["rows"] == 5900 and tdev["rows_masked"] > 0 and tdev["pauses"] > 0


def test_snapshot_is_idempotent_and_streaming_continues():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 300, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    plan = _torch_plan((tapi.AggSpec("sum", "v"),))
    h = plan.stream(_chunks_of(keys, vals, 1024))
    h.pump(2)
    s1, s2 = h.snapshot(), h.snapshot()
    assert torch.equal(s1["sum(v)"], s2["sum(v)"])
    h.pump()
    final = h.result()
    assert not torch.equal(s1["sum(v)"], final["sum(v)"])
    assert h.stats()["chunks_consumed"] == 4
    whole = plan.collect(next(_chunks_of(keys, vals, 4096)))
    assert torch.equal(whole["key"], final["key"])


def test_sources_agree():
    rng = np.random.default_rng(10)
    keys = rng.integers(0, 200, size=3000).astype(np.int64)
    vals = rng.normal(size=3000).astype(np.float32)
    plan = _torch_plan((tapi.AggSpec("count"),), max_groups=256)
    outs = [
        plan.collect(tpipe.ArraySource({"__key__": torch.from_numpy(keys),
                                        "v": torch.from_numpy(vals)}, chunk_rows=1000)),
        plan.collect(tpipe.BlockSource(tuple({"__key__": keys[i:i + 1000], "v": vals[i:i + 1000]}
                                             for i in range(0, 3000, 1000)))),
        plan.collect(tpipe.IterableSource(lambda: _chunks_of(keys.astype(np.uint32), vals, 1000))),
    ]
    for o in outs[1:]:
        assert torch.equal(o["key"], outs[0]["key"])
        assert torch.equal(o["count(*)"], outs[0]["count(*)"])


@pytest.mark.parametrize("kind", ["count", "sum"])
def test_groupby_kernel_front_door(kind):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 250, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    for fused in (True, False):  # the fused route, then the default split route
        tk_, ta, tn = tops.groupby_kernel(torch.from_numpy(keys.astype(np.int64)),
                                          torch.from_numpy(vals), kind=kind, max_groups=512,
                                          morsel_size=512, fused=fused, device="cpu")
        jk, ja, jn = jops.groupby_kernel(jnp.asarray(keys), jnp.asarray(vals), kind=kind,
                                         max_groups=512, morsel_size=512, fused=fused)
        n = int(jn)
        assert int(tn) == n
        assert np.array_equal(tk_.numpy()[:n], np.asarray(jk)[:n].astype(np.int64))
        np.testing.assert_allclose(ta.numpy()[:n], np.asarray(ja)[:n], rtol=1e-6, atol=1e-6)
    default = tops.groupby_kernel(torch.from_numpy(keys.astype(np.int64)),
                                  torch.from_numpy(vals), kind=kind, max_groups=512,
                                  morsel_size=512, device="cpu")
    assert torch.equal(default[0], tk_) and torch.equal(default[1], ta)  # fused=False


# once out of the slice, now ported (tests/test_torch_partitioned.py,
# tests/test_torch_spill.py, tests/test_torch_sharded.py): each runs against
# the oracle and the JAX plan (sharded: on a one-member mesh of each package)
ONCE_OUT_OF_SLICE = {
    "strategy_partitioned": dict(strategy="partitioned"),
    "ticketing_sort": dict(execution=dict(ticketing="sort")),
    "saturation_spill": dict(saturation="spill", max_groups=64),
    "strategy_sharded": dict(strategy="sharded"),
}


def _one_member_mesh(api):
    if api is tapi:
        from repro_torch.parallel import sharding

        return sharding.make_mesh((1,), ("data",),
                                  devices=[sharding.MeshDevice(0, torch.device("cpu"))])
    import jax

    return jax.make_mesh((1,), ("data",))


@pytest.mark.parametrize("case", sorted(ONCE_OUT_OF_SLICE))
def test_once_out_of_slice_plans_run_against_the_oracle_and_jax(case):
    rng = np.random.default_rng(43)
    keys = rng.integers(0, 300, size=4096).astype(np.uint32)
    keys[::5] += np.uint32(1 << 31)
    vals = rng.integers(0, 100, size=4096).astype(np.float32)  # exact in any order
    kw = dict(ONCE_OUT_OF_SLICE[case])
    ex = kw.pop("execution", {})
    outs = []
    for api in (tapi, japi):
        if kw.get("strategy") == "sharded":
            ex = dict(ex, mesh=_one_member_mesh(api))
        plan = api.GroupByPlan(
            keys=("k",), aggs=(api.AggSpec("sum", "v"),),
            strategy=kw.get("strategy", "concurrent"), max_groups=kw.get("max_groups", 1024),
            saturation=kw.get("saturation", "raise"), raw_keys=True,
            execution=api.ExecutionPolicy(**ex, **({"device": "cpu"} if api is tapi else {})))
        if api is tapi:
            chunks = [tcol.Table({"k": torch.from_numpy(keys[i:i + 1024].view(np.int32)),
                                  "v": torch.from_numpy(vals[i:i + 1024])})
                      for i in range(0, 4096, 1024)]
        else:
            chunks = [jcol.Table({"k": jnp.asarray(keys[i:i + 1024]),
                                  "v": jnp.asarray(vals[i:i + 1024])})
                      for i in range(0, 4096, 1024)]
        outs.append(_map(plan.collect(chunks), "sum(v)"))
    want = _np_sums(keys, vals)
    assert outs[0] == want and outs[1] == want


# spill plans that the reference rejects with ValueError (not merely unported)
INVALID_SPILL = {
    "strategy_hybrid": dict(strategy="hybrid"),
    "strategy_partitioned": dict(strategy="partitioned"),
    "strategy_sharded": dict(strategy="sharded"),
    "ticketing_sort": dict(ticketing="sort"),
    "ticketing_direct": dict(ticketing="direct"),
}


@pytest.mark.parametrize("case", sorted(INVALID_SPILL))
def test_invalid_spill_plans_raise_value_error_as_in_the_reference(case):
    from repro.engine import executors as jex

    kw = dict(INVALID_SPILL[case])
    strategy = kw.pop("strategy", "concurrent")
    for api, make in ((japi, jex.make_executor), (tapi, tex.make_executor)):
        ex = dict(kernel=None, **kw)
        if api is tapi:
            ex["device"] = "cpu"
        plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"),), strategy=strategy,
                               max_groups=64, saturation="spill",
                               execution=api.ExecutionPolicy(**ex))
        with pytest.raises(ValueError, match="spill"):
            make(plan)
    # a valid concurrent hash spill plan runs (engine/spill.py)
    plan = tapi.GroupByPlan(keys=("k",), aggs=(tapi.AggSpec("count"),), strategy="concurrent",
                            max_groups=64, saturation="spill", raw_keys=True,
                            execution=tapi.ExecutionPolicy(kernel=None, device="cpu"))
    keys = torch.arange(300, dtype=torch.int32).repeat(3)
    out = plan.collect(tcol.Table({"k": keys}))
    assert _map(out, "count(*)") == {k: 3.0 for k in range(300)}


# once out of the slice, now the scan route (tests/test_torch_scan.py)
SCAN_ROUTE = {
    "kernel_none": dict(kernel=None),
    "kernel_off": dict(kernel="off"),
    "kernel_scan_body": dict(kernel="scan_body"),
    "use_kernel": dict(kernel=None, use_kernel=True),
}


@pytest.mark.parametrize("case", sorted(SCAN_ROUTE))
def test_scan_route_plans_run_and_match_the_oracle(case):
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 300, size=3000).astype(np.uint32)
    vals = rng.normal(size=3000).astype(np.float32)
    plan = tapi.GroupByPlan(
        keys=("k",), aggs=(tapi.AggSpec("count"), tapi.AggSpec("sum", "v")),
        strategy="concurrent", max_groups=512, raw_keys=True,
        execution=tapi.ExecutionPolicy(device="cpu", morsel_rows=512, **SCAN_ROUTE[case]))
    if case == "use_kernel":
        tex.reset_kernel_alias_warnings()
        with pytest.warns(DeprecationWarning, match="use_kernel"):
            ex = tex.make_executor(plan)
    else:
        ex = tex.make_executor(plan)
    assert isinstance(ex, tex._ScanExecutor)
    assert ex._op.use_kernel == (case in ("kernel_scan_body", "use_kernel"))
    out = plan.collect([tcol.Table({"k": torch.from_numpy(keys[i:i + 1000].astype(np.int64)),
                                    "v": torch.from_numpy(vals[i:i + 1000])})
                        for i in range(0, 3000, 1000)])
    _assert_maps_close(_map(out, "sum(v)"), _np_sums(keys, vals))
    counts = dict(zip(*np.unique(keys, return_counts=True)))
    assert _map(out, "count(*)") == {int(k): float(c) for k, c in counts.items()}


def test_invalid_kernel_combinations_raise_value_error():
    for bad in (
        dict(strategy="hybrid", execution=tapi.ExecutionPolicy(kernel="fused")),
        dict(strategy="concurrent", saturation="spill",
             execution=tapi.ExecutionPolicy(kernel="fused")),
        dict(strategy="concurrent",
             execution=tapi.ExecutionPolicy(kernel="fused", ticketing="sort")),
    ):
        plan = tapi.GroupByPlan(keys=("k",), aggs=(tapi.AggSpec("count"),),
                                max_groups=64, **bad)
        with pytest.raises(ValueError):
            tex.make_executor(plan)
    with pytest.raises(ValueError):
        tapi.GroupByPlan(keys=("k",), aggs=(tapi.AggSpec("count"),),
                         execution=tapi.ExecutionPolicy(kernel="bogus"))


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tapi.GroupByPlan(keys=("k",), aggs=(tapi.AggSpec("count"),),
                            strategy="concurrent", max_groups=64,
                            execution=tapi.ExecutionPolicy(kernel="fused"))
    assert plan.execution.device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.make_executor(plan)
    with pytest.raises(RuntimeError):
        plan.stream([])


def test_checkpoints_not_ported(tmp_path):
    """Stream checkpoints (named from when they were not ported): a stream
    saved before its first chunk restores with nothing consumed, one saved
    after its only chunk restores finished, both with the uninterrupted
    run's table; the fused route alone refuses to save, as in the
    reference."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 300, size=1024).astype(np.uint32)
    vals = rng.integers(0, 100, size=1024).astype(np.float32)
    aggs = (tapi.AggSpec("count"), tapi.AggSpec("sum", "v"))
    table, _ = tapi.arrays_as_table(torch.from_numpy(keys.astype(np.int64)),
                                    torch.from_numpy(vals))
    fused = _torch_plan(aggs)
    with pytest.raises(TypeError, match="does not support checkpointing"):
        fused.stream([table]).save(str(tmp_path / "fused"))
    plan = _torch_plan(aggs, execution=dict(kernel=None))
    want = plan.collect([table])
    h = plan.stream([table])
    h.save(str(tmp_path / "empty"))
    h2 = plan.restore(str(tmp_path / "empty"), [table])
    assert h2.chunks_consumed == 0 and h2.rows_consumed == 0
    got = h2.result()
    h.pump()
    h.save(str(tmp_path / "one"))
    h3 = plan.restore(str(tmp_path / "one"), [table])
    assert h3.chunks_consumed == 1 and h3.rows_consumed == 1024 and h3.pump() == 0
    for out in (got, h3.result(), h.result()):
        for col in want.columns:
            assert torch.equal(out[col], want[col]), col


def test_registry_publishing_matches_jax():
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 100, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    aggs = (tapi.AggSpec("count"),)  # the count-only plan of groupby_kernel
    from repro_torch.obs import metrics as tmet

    snaps = []
    for met, run in ((tmet, lambda: _run_torch(keys, vals, aggs, max_groups=512)),
                     (jmet, lambda: _run_jax(keys, vals, aggs, max_groups=512,
                                             execution=dict(kernel="fused")))):
        met.clear()
        met.enable()
        try:
            run()
            snaps.append(met.snapshot())
        finally:
            met.disable()
            met.clear()
    assert snaps[0] == snaps[1]
