"""Stream checkpoints of repro_torch (``engine/elastic.py``,
``checkpoint/manager.py``) on the CPU (``device="cpu"``: the plain versions
of the kernels).

The first half mirrors the single-device tests of tests/test_elastic.py
(same seeds, sizes and oracle): save/restore exactness across strategies ×
distributions × snapshot points, a restored mid-stream snapshot,
crash-mid-save atomicity, validations, the server's restore-on-failure
path, and spill's staged batches.  Added: round trips of the hybrid,
escalated auto, split and partitioned plans, the fused route's refusal,
``remesh_stream`` on a stream that is not sharded, and the async
``CheckpointManager``'s host copy.

The second half holds the commit format to the JAX package's, both ways:
the JAX package saves mid-stream and the port restores and finishes, and
the port saves and the JAX package restores, for every serialized
executor; and a ``CheckpointManager`` tree each way, key path for key
path.

Tolerance: values are integer-valued float32, so every SUM is exact below
2^24 whatever the fold order; SUM, COUNT, key sets and group counts are
compared exactly, as key → value maps (and in ticket order where the
port's plain path tickets as the reference does).
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data.pipeline import IterableSource as JIterableSource
from repro.engine import plan_api as japi
from repro.engine.columns import Table as JTable
from repro_torch.checkpoint import manager as tckpt
from repro_torch.checkpoint.manager import latest_commit_step
from repro_torch.core import groupby_oracle
from repro_torch.data.pipeline import IterableSource
from repro_torch.engine import elastic as telastic_streams
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.columns import Table
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.query_server import AggregationServer
from repro_torch.train.elastic import WorkerFailure

AggSpec, ExecutionPolicy, GroupByPlan = tapi.AggSpec, tapi.ExecutionPolicy, tapi.GroupByPlan
SaturationPolicy = tapi.SaturationPolicy

RNG = np.random.default_rng(31)
N = 4096
CHUNK = 512
N_CHUNKS = N // CHUNK
CPU = ExecutionPolicy(device="cpu")


def gen_keys(dist: str) -> np.ndarray:
    if dist == "uniform":
        return RNG.integers(0, 500, size=N).astype(np.uint32)
    assert dist == "zipf"
    return (RNG.zipf(1.3, size=N) % (N // 4)).astype(np.uint32)


def int_vals(n: int = N) -> np.ndarray:
    # integer-valued f32: any fold order sums exactly below 2**24
    return RNG.integers(0, 100, size=n).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def source(keys, vals, chunk=CHUNK):
    def gen():
        for i in range(0, len(keys), chunk):
            yield Table({"k": _t(keys[i:i + chunk]), "v": _t(vals[i:i + chunk])})
    return IterableSource(gen)


def jax_source(keys, vals, chunk=CHUNK):
    def gen():
        for i in range(0, len(keys), chunk):
            yield JTable({"k": jnp.asarray(keys[i:i + chunk]),
                          "v": jnp.asarray(vals[i:i + chunk])})
    return JIterableSource(gen)


def table_map(out, name: str = "sum(v)") -> dict:
    n = int(np.asarray(out["__num_groups__"])[0])
    return {int(k): float(v)
            for k, v in zip(np.asarray(out["key"])[:n], np.asarray(out[name])[:n])}


def oracle_map(keys, vals, kind="sum") -> dict:
    ref = groupby_oracle(_t(keys), _t(vals), kind=kind, max_groups=len(keys))
    n = int(ref.num_groups)
    return {int(k): float(v)
            for k, v in zip(np.asarray(ref.keys)[:n], np.asarray(ref.values)[:n])}


def make_plan(strategy: str) -> GroupByPlan:
    aggs = (AggSpec("sum", "v"), AggSpec("count"))
    if strategy == "spill":
        return GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent",
                           max_groups=64, saturation=SaturationPolicy.SPILL,
                           raw_keys=True,
                           execution=ExecutionPolicy(spill_partitions=8, device="cpu"))
    if strategy == "auto":
        return GroupByPlan(keys=("k",), aggs=aggs, strategy="auto",
                           raw_keys=True, execution=CPU)
    assert strategy == "concurrent"
    return GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent",
                       max_groups=128, saturation=SaturationPolicy.GROW,
                       raw_keys=True, execution=CPU)


# ---------------------------------------------------------------------------
# checkpoint/restore exactness matrix (tests/test_elastic.py)


@pytest.mark.parametrize("strategy,dist,snap_at", [
    ("concurrent", "uniform", 2), ("concurrent", "uniform", 6),
    ("concurrent", "zipf", 2), ("concurrent", "zipf", 6),
    ("spill", "uniform", 2), ("spill", "uniform", 6),
    ("spill", "zipf", 2), ("spill", "zipf", 6),
    ("auto", "uniform", 2), ("auto", "zipf", 6),
])
def test_save_restore_matrix(strategy, dist, snap_at, tmp_path):
    """save() at an early/late chunk boundary, restore into a FRESH
    executor, drain — exact vs the uninterrupted stream AND the oracle,
    for both SUM and COUNT."""
    keys, vals = gen_keys(dist), int_vals()
    plan = make_plan(strategy)
    src = source(keys, vals)

    h = plan.stream(src)
    h.pump(snap_at)
    h.save(str(tmp_path))
    # the original keeps consuming after a save — checkpointing is not a
    # pause — and still matches
    straight = table_map(h.result())

    h2 = plan.restore(str(tmp_path), src)
    assert h2.chunks_consumed == snap_at
    out = h2.result()
    assert table_map(out) == straight == oracle_map(keys, vals)
    assert table_map(out, "count(*)") == oracle_map(keys, vals, "count")


def test_restore_mid_stream_snapshot_matches(tmp_path):
    """A restored stream's mid-stream snapshot equals the saved stream's
    snapshot at the same boundary: state round-trips exactly, not merely
    the final result."""
    keys, vals = gen_keys("uniform"), int_vals()
    plan = make_plan("concurrent")
    src = source(keys, vals)
    h = plan.stream(src)
    h.pump(3)
    before = table_map(h.snapshot())
    h.save(str(tmp_path))
    h2 = plan.restore(str(tmp_path), src)
    assert table_map(h2.snapshot()) == before


def test_sort_and_direct_round_trip(tmp_path):
    """The one-shot (sort) and perfect-hash (direct) ticketing executors
    checkpoint their buffered/carried state too."""
    keys = RNG.integers(0, 200, size=N).astype(np.uint32)
    vals = int_vals()
    oracle = oracle_map(keys, vals)
    sort_plan = GroupByPlan(
        keys=("k",), aggs=(AggSpec("sum", "v"),), strategy="concurrent",
        max_groups=256, raw_keys=True,
        execution=ExecutionPolicy(ticketing="sort", device="cpu"),
    )
    direct_plan = GroupByPlan(
        keys=("k",), aggs=(AggSpec("sum", "v"),), strategy="concurrent",
        max_groups=256, raw_keys=True, saturation=SaturationPolicy.GROW,
        execution=ExecutionPolicy(ticketing="direct", key_domain=256, device="cpu"),
    )
    for i, plan in enumerate((sort_plan, direct_plan)):
        src = source(keys, vals)
        # direct ticketing materializes its whole declared domain (identity
        # values in untouched slots), so the reference is the uninterrupted
        # run — which itself must agree with the oracle on every seen key
        straight = table_map(plan.collect(src))
        assert all(straight[k] == v for k, v in oracle.items())
        h = plan.stream(src)
        h.pump(4)
        path = str(tmp_path / f"p{i}")
        h.save(path)
        assert table_map(plan.restore(path, src).result()) == straight


def test_crash_mid_save_leaves_last_commit_restorable(tmp_path):
    """The atomic-commit contract: a torn ``.tmp_step_*`` dir from a
    crashed save is invisible — restore resumes from the last full
    commit."""
    keys, vals = gen_keys("uniform"), int_vals()
    plan = make_plan("concurrent")
    src = source(keys, vals)
    h = plan.stream(src)
    h.pump(3)
    h.save(str(tmp_path))
    # simulate a crash mid-save of a LATER step: a half-written temp dir
    torn = tmp_path / ".tmp_step_7"
    torn.mkdir()
    (torn / "stream.npz").write_bytes(b"\x00garbage")
    assert latest_commit_step(str(tmp_path)) == 3
    h2 = plan.restore(str(tmp_path), src)
    assert h2.chunks_consumed == 3
    assert table_map(h2.result()) == oracle_map(keys, vals)


def test_save_is_atomic_replace(tmp_path):
    """Re-saving at a later boundary commits a new step; restore picks the
    newest and fast-forwards further."""
    keys, vals = gen_keys("uniform"), int_vals()
    plan = make_plan("concurrent")
    src = source(keys, vals)
    h = plan.stream(src)
    h.pump(2)
    h.save(str(tmp_path))
    h.pump(3)
    h.save(str(tmp_path))
    assert latest_commit_step(str(tmp_path)) == 5
    h2 = plan.restore(str(tmp_path), src)
    assert h2.chunks_consumed == 5
    assert table_map(h2.result()) == oracle_map(keys, vals)


def test_restore_validations(tmp_path):
    keys, vals = gen_keys("uniform"), int_vals()
    plan = make_plan("concurrent")
    src = source(keys, vals)
    with pytest.raises(FileNotFoundError):
        plan.restore(str(tmp_path / "nope"), src)
    h = plan.stream(src)
    h.pump(2)
    h.save(str(tmp_path))
    other = plan.with_(aggs=(AggSpec("min", "v"),))
    with pytest.raises(ValueError, match="different query"):
        other.restore(str(tmp_path), src)
    # a source shorter than the checkpoint cursor cannot be fast-forwarded
    with pytest.raises(ValueError, match="exhausted"):
        plan.restore(str(tmp_path), source(keys[:CHUNK], vals[:CHUNK]))
    h.cancel()
    with pytest.raises(ValueError):
        h.save(str(tmp_path))


# ---------------------------------------------------------------------------
# server restore-from-checkpoint fallback (non-sharded strategies)


class FlakySource:
    """Re-iterable source that raises WorkerFailure once, at chunk
    ``fail_at`` of its FIRST pass — the simulated device-loss signal for a
    non-meshed stream."""

    def __init__(self, keys, vals, fail_at: int):
        self._keys, self._vals = keys, vals
        self._fail_at = fail_at
        self._failed_once = False

    def chunks(self):
        for i in range(0, len(self._keys), CHUNK):
            if (not self._failed_once and i // CHUNK == self._fail_at):
                self._failed_once = True
                raise WorkerFailure([0])
            yield Table({"k": _t(self._keys[i:i + CHUNK]),
                         "v": _t(self._vals[i:i + CHUNK])})


def test_server_restores_from_checkpoint_on_failure(tmp_path):
    keys, vals = gen_keys("uniform"), int_vals()
    obs_metrics.enable()
    obs_metrics.clear()
    try:
        server = AggregationServer(slots=2)
        q = server.submit(
            make_plan("concurrent"), FlakySource(keys, vals, fail_at=4),
            tenant="alice", checkpoint_dir=str(tmp_path), checkpoint_every=2,
        )
        out = table_map(q.result())
        assert out == oracle_map(keys, vals)
        prof = q.profile()
        assert prof["recoveries"]["restores"] == 1
        snap = obs_metrics.snapshot()
        recov = snap["counters"]["serve.recovery"]
        assert any("kind=restore" in lbl and "tenant=alice" in lbl
                   for lbl in recov)
    finally:
        obs_metrics.disable()
        obs_metrics.clear()


# ---------------------------------------------------------------------------
# async spill flush: save() settles staged batches


def test_spill_checkpoint_flushes_staged(tmp_path):
    """save() must settle staged cold batches into the manifest — a
    restore from the commit replays every spilled row."""
    keys = RNG.integers(0, 1000, size=N).astype(np.uint32)
    vals = int_vals()
    plan = make_plan("spill")
    src = source(keys, vals)
    h = plan.stream(src)
    h.pump(5)
    h.save(str(tmp_path))
    h2 = plan.restore(str(tmp_path), src)
    assert h2.stats()["spilled_rows"] == h.stats()["spilled_rows"]
    assert table_map(h2.result()) == oracle_map(keys, vals)


# ---------------------------------------------------------------------------
# the port's additions: the other executors, refusals, the async manager


def _escalation_data(seed=23, n_chunk=4096, n_chunks=6):
    """Uniform keys over 20000 for two chunks, then three quarters of each
    chunk's rows on key 7: a default plan resolves to the scan route and
    escalates to hybrid at its third chunk (tests/test_stream.py's shape,
    cut to 4096-row chunks)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_chunks):
        k = rng.integers(0, 20000, size=n_chunk).astype(np.uint32)
        if i >= 2:
            k[rng.random(n_chunk) < 0.75] = 7
        parts.append(k)
    keys = np.concatenate(parts)
    return keys, rng.integers(0, 100, size=keys.size).astype(np.float32), n_chunk


def _plan_kw(case):
    """(plan fields, snapshot chunk, data) of each serialized executor."""
    aggs = (("sum", "v"), ("count", None))
    data = None
    if case == "scan":
        kw = dict(strategy="concurrent", max_groups=128, saturation="grow")
    elif case == "auto":
        kw = dict(strategy="auto")
    elif case == "auto_escalated":
        kw = dict(strategy="auto")
        data = _escalation_data()
    elif case == "hybrid":
        kw = dict(strategy="hybrid", max_groups=1024, saturation="raise")
    elif case == "direct":
        kw = dict(strategy="concurrent", max_groups=512, saturation="grow",
                  execution=dict(ticketing="direct", key_domain=512))
    elif case == "sort":
        kw = dict(strategy="concurrent", max_groups=1024, execution=dict(ticketing="sort"))
    elif case == "split":
        kw = dict(strategy="concurrent", max_groups=128, saturation="grow",
                  execution=dict(kernel="split"))
    elif case == "partitioned":
        kw = dict(strategy="partitioned", max_groups=1024)
        aggs = (("sum", "v"),)
    else:
        assert case == "spill"
        kw = dict(strategy="concurrent", max_groups=64, saturation="spill",
                  execution=dict(spill_partitions=8))
    if data is None:
        rng = np.random.default_rng(41)
        keys = rng.integers(0, 500, size=N).astype(np.uint32)
        keys[: N // 3] = 7  # a heavy hitter for the hybrid registers
        rng.shuffle(keys)
        data = (keys, rng.integers(0, 100, size=N).astype(np.float32), CHUNK)
    return kw, aggs, data


def _plan(api, case, device="cpu"):
    kw, aggs, _ = _plan_kw(case)
    ex = dict(kw.pop("execution", {}))
    if api is tapi:
        ex["device"] = device
    return api.GroupByPlan(keys=("k",), aggs=tuple(api.AggSpec(k, c) for k, c in aggs),
                           raw_keys=True, execution=api.ExecutionPolicy(**ex), **kw)


TORCH_CASES = ("hybrid", "auto_escalated", "split", "partitioned")


@pytest.mark.parametrize("case", TORCH_CASES)
def test_round_trip_of_the_other_executors(case, tmp_path):
    """Hybrid, an escalated default plan, split and partitioned: save at
    chunk 4, restore into a fresh executor of the same kind, finish; the
    map equals the uninterrupted run's and the oracle's."""
    _, _, (keys, vals, chunk) = _plan_kw(case)
    plan = _plan(tapi, case)
    h = plan.stream(source(keys, vals, chunk))
    h.pump(4)
    saved = h.executor
    if case == "auto_escalated":
        assert saved._escalated and isinstance(saved._inner, tex._HybridExecutor)
    h.save(str(tmp_path))
    straight = table_map(h.result())
    h2 = plan.restore(str(tmp_path), source(keys, vals, chunk))
    assert type(h2.executor) is type(saved)
    if case == "auto_escalated":
        assert h2.executor._escalated
        assert isinstance(h2.executor._inner, tex._HybridExecutor)
    assert table_map(h2.result()) == straight == oracle_map(keys, vals)


def test_fused_stream_refuses_to_save(tmp_path):
    """The fused route carries no serializer in the reference either."""
    plan = GroupByPlan(keys=("k",), aggs=(AggSpec("count"),), strategy="concurrent",
                       max_groups=1024, raw_keys=True,
                       execution=ExecutionPolicy(kernel="fused", morsel_size=512,
                                                 device="cpu"))
    keys, vals = gen_keys("uniform"), int_vals()
    h = plan.stream(source(keys, vals))
    h.pump(2)
    with pytest.raises(TypeError, match="_FusedExecutor does not support checkpointing"):
        h.save(str(tmp_path))
    assert latest_commit_step(str(tmp_path)) is None


def test_remesh_needs_a_sharded_stream():
    keys, vals = gen_keys("uniform"), int_vals()
    h = make_plan("concurrent").stream(source(keys, vals))
    h.pump(1)
    assert telastic_streams.stream_mesh(h) is None
    with pytest.raises(TypeError, match="strategy='sharded'"):
        telastic_streams.remesh_stream(h)
    h.cancel()
    with pytest.raises(ValueError):
        telastic_streams.remesh_stream(h)


def test_async_save_copies_to_host_before_returning(tmp_path):
    """``save`` returns while its thread writes; a tensor changed in place
    after it returns must not reach the commit."""
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "layers": [torch.ones(4), (torch.zeros(2, dtype=torch.int32),)]}
    want = {"w": params["w"].clone(), "layers": [params["layers"][0].clone(),
                                                 (params["layers"][1][0].clone(),)]}
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, params)
    params["w"].add_(100.0)                 # in place, while the write may run
    params["layers"][0].mul_(-1.0)
    params["layers"][1][0].fill_(9)
    mgr.wait()
    got, step = mgr.restore_latest(params)
    assert step == 3
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["layers"][0], want["layers"][0])
    assert torch.equal(got["layers"][1][0], want["layers"][1][0])
    with np.load(os.path.join(str(tmp_path), "step_00000003", "params.npz")) as z:
        assert sorted(z.files) == ["layers/0", "layers/1/0", "w"]


# ---------------------------------------------------------------------------
# the commit format, both ways against the JAX package


CROSS_CASES = ("scan", "auto", "auto_escalated", "hybrid", "direct", "sort", "split",
               "partitioned", "spill")
SNAP = 4


def _maps(out, aggs):
    cols = [AggSpec(k, c).name for k, c in aggs]
    return {c: table_map(out, c) for c in cols}


def _rows(out) -> dict:
    n = int(np.asarray(out["__num_groups__"])[0])
    return {c: np.asarray(out[c])[:n].astype(np.float64) for c in out.columns}


def _assert_same_tables(got, want):
    """Row for row, in ticket order: keys, every aggregate, the count."""
    g, w = _rows(got), _rows(want)
    assert g.keys() == w.keys()
    for c in w:
        assert np.array_equal(g[c], w[c]), c


def _assert_holds_oracle(out, keys, vals):
    """SUM and COUNT of every key the rows hold (direct ticketing also
    materializes the unseen keys of its domain, with count 0)."""
    sums, counts = table_map(out), table_map(out, "count(*)") if "count(*)" in out.columns else None
    seen = {k: v for k, v in sums.items() if counts is None or counts[k] > 0}
    assert seen == oracle_map(keys, vals)


def _cross(case, tmp_path, writer, writer_source, other, other_source):
    """``writer`` saves at chunk 4 and finishes uninterrupted elsewhere;
    both packages restore the commit.  Returns (the writer's uninterrupted
    result, the other package's restored result, the writer's restored
    result)."""
    _, aggs, (keys, vals, chunk) = _plan_kw(case)
    wplan, oplan = _plan(writer, case), _plan(other, case)
    want = wplan.collect(writer_source(keys, vals, chunk))
    h = wplan.stream(writer_source(keys, vals, chunk))
    h.pump(SNAP)
    h.save(str(tmp_path))
    outs = []
    for plan, src in ((oplan, other_source), (wplan, writer_source)):
        restored = plan.restore(str(tmp_path), src(keys, vals, chunk))
        assert restored.chunks_consumed == SNAP
        outs.append(restored.result())
    return want, outs[0], outs[1], aggs, keys, vals


@pytest.mark.parametrize("case", CROSS_CASES)
def test_jax_commit_restores_in_the_port(case, tmp_path):
    """The JAX package saves at chunk 4; the port restores and finishes
    with the JAX package's uninterrupted map, and with the JAX package's
    own restore of the commit row for row (a restore may order tickets
    otherwise than the uninterrupted run: the save drains the in-flight
    window, so pauses resolve at other points)."""
    want, got, jgot, aggs, keys, vals = _cross(case, tmp_path, japi, jax_source,
                                               tapi, source)
    with open(os.path.join(str(tmp_path), f"step_{SNAP:08d}", "meta.json")) as f:
        assert json.load(f)["format"] == telastic_streams.FORMAT
    assert _maps(got, aggs) == _maps(want, aggs)
    _assert_same_tables(got, jgot)
    _assert_holds_oracle(got, keys, vals)


@pytest.mark.parametrize("case", CROSS_CASES)
def test_port_commit_restores_in_jax(case, tmp_path):
    """The port saves at chunk 4; the JAX package restores and finishes
    with the port's uninterrupted map, and with the port's own restore of
    the commit row for row."""
    want, got, tgot, aggs, keys, vals = _cross(case, tmp_path, tapi, source,
                                               japi, jax_source)
    assert _maps(got, aggs) == _maps(want, aggs)
    _assert_same_tables(got, tgot)
    _assert_holds_oracle(tgot, keys, vals)


def _tree(lib):
    """A nested dict / list / tuple tree of arrays, as either package
    holds it."""
    rng = np.random.default_rng(7)
    arrs = {"emb": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.integers(0, 9, size=(5,)).astype(np.int32),
            "h": rng.normal(size=(2,)).astype(np.float32),
            "s": np.asarray(3.5, np.float32)}
    mk = jnp.asarray if lib == "jax" else torch.from_numpy
    tree = {"layers": [{"w": mk(arrs["emb"]), "b": mk(arrs["b"])},
                       (mk(arrs["h"]), mk(arrs["s"]))],
            "head": mk(arrs["h"])}
    return tree, arrs


def _leaf_arrays(tree):
    return {"layers/0/w": tree["layers"][0]["w"], "layers/0/b": tree["layers"][0]["b"],
            "layers/1/0": tree["layers"][1][0], "layers/1/1": tree["layers"][1][1],
            "head": tree["head"]}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_manager_trees_cross_packages(direction, tmp_path):
    """One package's ``CheckpointManager`` saves a nested tree, the other
    restores it into its own template: the same key paths, shapes, dtypes
    and values, exactly."""
    jtree, arrs = _tree("jax")
    ttree, _ = _tree("torch")
    writer, reader = ((jckpt, tckpt) if direction == "jax_to_port" else (tckpt, jckpt))
    src, template = (jtree, ttree) if direction == "jax_to_port" else (ttree, jtree)
    w = writer.CheckpointManager(str(tmp_path), async_save=False)
    w.save(12, src, opt_state={"m": src["head"]})
    with np.load(os.path.join(str(tmp_path), "step_00000012", "params.npz")) as z:
        assert sorted(z.files) == sorted(_leaf_arrays(src))
    r = reader.CheckpointManager(str(tmp_path), async_save=False)
    params, opt, step = r.restore_latest(template, {"m": template["head"]})
    assert step == 12 and r.latest_step() == 12
    want = {"layers/0/w": arrs["emb"], "layers/0/b": arrs["b"], "layers/1/0": arrs["h"],
            "layers/1/1": arrs["s"], "head": arrs["h"]}
    for key, leaf in _leaf_arrays(params).items():
        a = np.asarray(leaf)
        assert a.dtype == want[key].dtype and np.array_equal(a, want[key]), key
    if direction == "jax_to_port":
        assert isinstance(params["layers"][1], tuple)
        assert isinstance(params["layers"][0]["w"], torch.Tensor)
    assert np.array_equal(np.asarray(opt["m"]), arrs["h"])


def test_commit_helpers_match_the_reference(tmp_path):
    """``commit_payload`` / ``latest_commit`` of both packages write and
    read the same directory layout."""
    payload = {"stream": {"a/b": np.arange(3, dtype=np.uint32)}}
    tckpt.commit_payload(str(tmp_path), 2, payload, {"x": 1})
    jckpt.commit_payload(str(tmp_path), 5, payload, {"x": 2})
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000002", "step_00000005"]
    for mod in (tckpt, jckpt):
        step, got, meta = mod.latest_commit(str(tmp_path), names=("stream",))
        assert step == 5 and meta == {"x": 2}
        assert np.array_equal(got["stream"]["a/b"], payload["stream"]["a/b"])
    assert tckpt.latest_commit(str(tmp_path / "none")) is None
