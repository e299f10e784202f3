"""The serving layer of repro_torch (``serve/scheduler.py``,
``serve/query_server.py``, ``engine.executors.batch_signature`` /
``consume_batched`` and ``fused_groupby.scan_ticket_batched``'s plain
version) against the JAX package, on the CPU.

Mirrors tests/test_serve_scheduler.py: the scheduler tests run the port's
``Scheduler`` and the JAX one on the same fake tasks and must give the same
sequence of quanta and the same errors; the server tests run
``device="cpu"`` plans through the port's ``AggregationServer`` beside the
JAX server.  Results are compared as maps: the same keys, COUNT exact, SUM
within 1e-5 of the group's Σ|v| (the port folds a chunk's tickets in one
call, the reference a morsel at a time, so float adds may run in another
order).  Within the port, a batched run is held to sequential
``plan.collect`` bit for bit, as the reference holds its own.  Then
``consume_batched`` against JAX ``consume_batched`` ticket for ticket, an
overflowing lane, ragged and masked rounds, eligibility, admission
control, and the package exports against the reference's."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.data.pipeline import ArraySource as JArraySource
from repro.engine import executors as jex
from repro.engine import plan_api as japi
from repro.serve import query_server as jqs
from repro.serve import scheduler as jsched
from repro_torch.data.pipeline import ArraySource as TArraySource
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.columns import Table as TTable
from repro_torch.engine.groupby import GroupByOverflowError as TOverflow
from repro_torch.kernels import fused_groupby as tfk
from repro_torch.serve import query_server as tqs
from repro_torch.serve import scheduler as tsched
from repro_torch.train import elastic as telastic

from repro.engine.columns import Table as JTable
from repro.engine.groupby import GroupByOverflowError as JOverflow

N = 4096
CHUNK = 512
SUM_RTOL = 1e-5


class FakeTask:
    """Deterministic SlotTask: ``length`` quanta, records every step."""

    def __init__(self, length, batch_key=None, log=None, name=""):
        self.length = length
        self.steps = 0
        self.batch_key = batch_key
        self.log = log if log is not None else []
        self.name = name
        self.cancelled = False

    @property
    def done(self):
        return self.steps >= self.length

    def step(self):
        self.steps += 1
        self.log.append(self.name)

    @staticmethod
    def step_batch(tasks):
        for t in tasks:
            t.step()

    def finish(self):
        return self.name

    def cancel(self):
        self.cancelled = True


def _both(scenario):
    """Run ``scenario(scheduler_module)`` on the port's and the JAX
    scheduler; both must return the same record."""
    got, want = scenario(tsched), scenario(jsched)
    assert got == want
    return got


# -- scheduler core --------------------------------------------------------------


def test_fairness_unequal_stream_lengths_no_starvation():
    def scenario(mod):
        sched = mod.Scheduler(slots=2)
        log = []
        short = sched.submit(FakeTask(4, log=log, name="short"), tenant="a")
        long = sched.submit(FakeTask(32, log=log, name="long"), tenant="b")
        rounds = 0
        while not short.terminal:
            sched.step()
            rounds += 1
        assert short.result() == "short"
        assert rounds <= 9
        assert abs(log[:8].count("short") - log[:8].count("long")) <= 1
        sched.run_until_idle()
        assert long.result() == "long"
        assert sched.tenant_stats("b")["steps"] == 32
        return rounds, log

    _both(scenario)


def test_fairness_weight_gives_proportional_quanta():
    def scenario(mod):
        sched = mod.Scheduler(slots=2)
        sched.set_budget("heavy", mod.TenantBudget(weight=3))
        log = []
        sched.submit(FakeTask(30, log=log, name="h"), tenant="heavy")
        sched.submit(FakeTask(30, log=log, name="l"), tenant="light")
        for _ in range(16):
            sched.step()
        assert log[:8] == ["h", "h", "h", "l", "h", "h", "h", "l"]
        return log

    _both(scenario)


def test_cancellation_frees_slot_and_next_admission_reuses_it():
    def scenario(mod):
        sched = mod.Scheduler(slots=1)
        first = sched.submit(FakeTask(100), tenant="a")
        second = sched.submit(FakeTask(3), tenant="b")
        sched.step()
        assert first.slot == 0 and second.status == "queued"
        sched.cancel(first)
        assert first.status == "cancelled" and first.task.cancelled
        assert second.slot == 0
        sched.run_until_idle()
        assert second.result() == ""
        with pytest.raises(mod.TaskCancelledError):
            first.result()
        return first.status, second.status, second.steps, sched.clock

    _both(scenario)


def test_tenant_max_steps_budget_fails_only_that_tenant():
    def scenario(mod):
        sched = mod.Scheduler(slots=2)
        sched.set_budget("capped", mod.TenantBudget(max_steps=5))
        capped = sched.submit(FakeTask(50), tenant="capped")
        free = sched.submit(FakeTask(12), tenant="free")
        sched.run_until_idle()
        assert capped.status == "failed"
        with pytest.raises(mod.BudgetExceededError):
            capped.result()
        assert free.status == "done" and free.task.steps == 12
        return capped.task.steps, str(capped.error), sched.clock

    _both(scenario)


def test_batch_key_groups_step_in_one_dispatch():
    def scenario(mod):
        calls = []

        class Batchy(FakeTask):
            @staticmethod
            def step_batch(tasks):
                calls.append(len(tasks))
                for t in tasks:
                    t.step()

        sched = mod.Scheduler(slots=4)
        handles = [sched.submit(Batchy(3, batch_key="g"), tenant=f"t{i}") for i in range(4)]
        sched.run_until_idle()
        assert all(h.status == "done" for h in handles)
        assert calls == [4, 4, 4]
        return calls

    _both(scenario)


def test_failure_isolated_to_one_slot():
    class Exploding(FakeTask):
        def step(self):
            raise RuntimeError("boom")

    def scenario(mod):
        sched = mod.Scheduler(slots=2)
        bad = sched.submit(Exploding(5), tenant="bad")
        good = sched.submit(FakeTask(4), tenant="good")
        sched.run_until_idle()
        assert bad.status == "failed" and good.status == "done"
        with pytest.raises(RuntimeError, match="boom"):
            bad.result()
        return bad.status, good.status, sched.clock

    _both(scenario)


def test_queue_depth_refuses_like_the_reference():
    def scenario(mod):
        sched = mod.Scheduler(slots=1)
        sched.set_budget("t", mod.TenantBudget(max_queue_depth=1))
        sched.submit(FakeTask(2), tenant="t")
        sched.submit(FakeTask(2), tenant="t")
        with pytest.raises(mod.QueueFullError):
            sched.submit(FakeTask(2), tenant="t")
        stats = sched.tenant_stats("t")
        return stats["queued"], stats["running"]

    assert _both(scenario) == (1, 1)


# -- aggregation server over real GROUP BY streams -------------------------------


def _np_cols(seed, n=N, card=200):
    r = np.random.default_rng(seed)
    return r.integers(0, card, size=n).astype(np.uint32), r.standard_normal(n).astype(np.float32)


def _tcols(seed, **kw):
    k, v = _np_cols(seed, **kw)
    return {"k": torch.from_numpy(k.view(np.int32)), "v": torch.from_numpy(v)}


def _jcols(seed, **kw):
    k, v = _np_cols(seed, **kw)
    return {"k": jnp.asarray(k), "v": jnp.asarray(v)}


def _plans(**kw):
    """The reference test's plan in both packages (the port's on the CPU)."""
    def make(api, device):
        base = dict(
            keys=("k",), aggs=(api.AggSpec("sum", "v"), api.AggSpec("count")),
            strategy="concurrent", max_groups=512,
            saturation=api.SaturationPolicy.UNCHECKED, raw_keys=True,
            execution=api.ExecutionPolicy(update="scatter", morsel_rows=256, **device),
        )
        base.update(kw)
        return api.GroupByPlan(**base)

    return make(tapi, {"device": "cpu"}), make(japi, {})


def _map(out, col="sum(v)"):
    n = int(np.asarray(out["__num_groups__"])[0])
    keys = np.asarray(out["key"]).astype(np.int64)[:n]
    return dict(zip(keys.tolist(), np.asarray(out[col])[:n].astype(np.float64).tolist()))


def _assert_same_map(tout, jout, keys=None, vals=None):
    """The port's result against JAX's as maps: keys and COUNT exact, SUM
    within SUM_RTOL of the group's Σ|v| (of |sum| when no input is given)."""
    t, j = _map(tout), _map(jout)
    assert t.keys() == j.keys()
    assert _map(tout, "count(*)") == _map(jout, "count(*)")
    scale = dict.fromkeys(j, 0.0)
    if keys is not None:
        for k, v in zip(keys.tolist(), np.abs(vals).tolist()):
            scale[k] += v
    for k in j:
        assert abs(t[k] - j[k]) <= SUM_RTOL * max(scale[k] or abs(j[k]), 1.0), k


def _assert_bitwise(got, want):
    for col in want.columns:
        assert torch.equal(got[col], want[col]), col


def _count_batched(monkeypatch):
    """Count ``scan_ticket_batched`` calls and their lanes (the CPU runs
    its plain version, which counts no launch)."""
    calls = []
    real = tfk.scan_ticket_batched

    def counted(tables, *a, **kw):
        calls.append(len(tables))
        return real(tables, *a, **kw)

    monkeypatch.setattr(tfk, "scan_ticket_batched", counted)
    return calls


def test_batched_dispatch_bit_identical_to_sequential_collect(monkeypatch):
    tplan, jplan = _plans()
    seeds = range(6)
    sequential = [tplan.collect(TArraySource(_tcols(i), chunk_rows=CHUNK)) for i in seeds]
    calls = _count_batched(monkeypatch)
    server = tqs.AggregationServer(slots=6, batch_queries=True)
    handles = [server.submit(tplan, TArraySource(_tcols(i), chunk_rows=CHUNK)) for i in seeds]
    server.run_until_idle()
    assert calls == [6] * (N // CHUNK)  # one ticket call a round, every lane in it
    jserver = jqs.AggregationServer(slots=6, batch_queries=True)
    jhandles = [jserver.submit(jplan, JArraySource(_jcols(i), chunk_rows=CHUNK)) for i in seeds]
    jserver.run_until_idle()
    for i, h, want, jh in zip(seeds, handles, sequential, jhandles):
        got = h.result()
        _assert_bitwise(got, want)
        _assert_same_map(got, jh.result(), *_np_cols(i))


def test_server_cancellation_mid_stream_frees_slot_for_queued_query():
    tplan, jplan = _plans()
    outs = []
    for qs, plan, cols, src in ((tqs, tplan, _tcols, TArraySource),
                                (jqs, jplan, _jcols, JArraySource)):
        server = qs.AggregationServer(slots=1)
        h1 = server.submit(plan, src(cols(0), chunk_rows=CHUNK), tenant="a")
        h2 = server.submit(plan, src(cols(1), chunk_rows=CHUNK), tenant="b")
        server.step(2)
        assert h1.chunks_consumed > 0 and h2.status == "queued"
        h1.cancel()
        assert h1.status == "cancelled" and h2.slot == 0
        server.run_until_idle()
        outs.append(h2.result())
        with pytest.raises((tsched if qs is tqs else jsched).TaskCancelledError):
            h1.result()
    _assert_bitwise(outs[0], tplan.collect(TArraySource(_tcols(1), chunk_rows=CHUNK)))
    _assert_same_map(outs[0], outs[1], *_np_cols(1))


def test_tenant_max_groups_budget_fails_only_offending_query():
    tplan, jplan = _plans()
    for qs, plan, cols, src, overflow in (
            (tqs, tplan, _tcols, TArraySource, TOverflow),
            (jqs, jplan, _jcols, JArraySource, JOverflow)):
        server = qs.AggregationServer(slots=2)
        server.set_budget("small", max_groups=64)
        over = server.submit(plan.with_(max_groups=None),
                             src(cols(9, card=500), chunk_rows=CHUNK), tenant="small")
        fine = server.submit(plan, src(cols(2), chunk_rows=CHUNK), tenant="other")
        server.run_until_idle()
        assert over.status == "failed" and isinstance(over.error, overflow)
        with pytest.raises(overflow):
            over.result()
        assert fine.status == "done"
        assert int(fine.result()["__num_groups__"][0]) == 200


def test_server_fairness_short_query_not_starved_by_long_stream():
    tplan, jplan = _plans()
    progress = []
    for qs, plan, cols, src in ((tqs, tplan, _tcols, TArraySource),
                                (jqs, jplan, _jcols, JArraySource)):
        server = qs.AggregationServer(slots=2, batch_queries=False)
        short = server.submit(plan, src(cols(0, n=2 * CHUNK), chunk_rows=CHUNK), tenant="a")
        long = server.submit(plan, src(cols(1, n=16 * CHUNK), chunk_rows=CHUNK), tenant="b")
        out = short.result()
        assert short.done and not long.done
        assert 1 <= long.chunks_consumed <= short.chunks_consumed + 2
        progress.append((short.chunks_consumed, long.chunks_consumed, out))
        server.run_until_idle()
        assert long.done
    assert progress[0][:2] == progress[1][:2]
    _assert_bitwise(progress[0][2],
                    tplan.collect(TArraySource(_tcols(0, n=2 * CHUNK), chunk_rows=CHUNK)))
    _assert_same_map(progress[0][2], progress[1][2], *_np_cols(0, n=2 * CHUNK))


def test_mid_stream_snapshot_per_query():
    tplan, jplan = _plans()
    snaps = []
    for qs, plan, cols, src in ((tqs, tplan, _tcols, TArraySource),
                                (jqs, jplan, _jcols, JArraySource)):
        server = qs.AggregationServer(slots=2)
        h = server.submit(plan, src(cols(4), chunk_rows=CHUNK))
        server.step(3)
        snap = h.snapshot()
        assert int(np.asarray(snap["__num_groups__"])[0]) > 0
        server.run_until_idle()
        final = h.snapshot()
        np.testing.assert_array_equal(np.asarray(final["sum(v)"]),
                                      np.asarray(h.result()["sum(v)"]))
        snaps.append((snap, final))
    k, v = _np_cols(4)
    _assert_same_map(snaps[0][0], snaps[1][0], k[:3 * CHUNK], v[:3 * CHUNK])
    _assert_same_map(snaps[0][1], snaps[1][1], k, v)


# -- consume_batched against JAX ---------------------------------------------------


def _executors(plans_of, n_lanes):
    tplan, jplan = plans_of
    txs = [tex.make_executor(tplan) for _ in range(n_lanes)]
    jxs = [jex.make_executor(jplan) for _ in range(n_lanes)]
    for x in txs + jxs:
        x.open()
    return txs, jxs


def _round(seeds, rows, card=300, offset=0, mask=False):
    """One chunk per lane: (port tables, JAX tables, numpy keys, values)."""
    tch, jch, raw = [], [], []
    for s in seeds:
        k, v = _np_cols(s, n=rows, card=card)
        k = k + np.uint32(offset)
        tcols = {"k": torch.from_numpy(k.view(np.int32)), "v": torch.from_numpy(v)}
        jcols = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        if mask:
            m = (np.arange(rows) % 3) != 0
            tcols["__mask__"] = torch.from_numpy(m)
            jcols["__mask__"] = jnp.asarray(m)
        tch.append(TTable(tcols))
        jch.append(JTable(jcols))
        raw.append((k, v))
    return tch, jch, raw


def _assert_lane_equal(tx, jx):
    """Ticket for ticket: the same key_by_ticket and count, and the
    accumulators within SUM_RTOL (COUNT exact)."""
    tt, jt = tx._op._table, jx._op._table
    assert int(tt.count) == int(jt.count)
    assert np.array_equal(tt.key_by_ticket.numpy().view(np.uint32),
                          np.asarray(jt.key_by_ticket))
    state = tx._op._state
    for spec, ta, ja in zip(state.specs, state.accs, jx._op._state.accs):
        ja = np.asarray(ja)
        if spec[1] == "count":
            assert np.array_equal(ta.numpy(), ja), spec
        else:
            assert np.allclose(ta.numpy(), ja, rtol=0, atol=SUM_RTOL * max(np.abs(ja).max(), 1)), spec


@pytest.mark.parametrize("saturation", ["raise", "unchecked"])
def test_consume_batched_equals_jax_ticket_for_ticket(saturation, monkeypatch):
    plans = _plans(saturation=saturation, max_groups=1024)
    txs, jxs = _executors(plans, 4)
    calls = _count_batched(monkeypatch)
    for r in range(3):
        tch, jch, _ = _round([10 * r + i for i in range(4)], CHUNK, card=700)
        tex.consume_batched(txs, tch)
        jex.consume_batched(jxs, jch)
    assert calls == [4, 4, 4]
    for tx, jx in zip(txs, jxs):
        _assert_lane_equal(tx, jx)
        _assert_same_map(tx.finalize(), jx.finalize())


def test_consume_batched_one_lane_overflows_only_that_query_raises(monkeypatch):
    plans = _plans(saturation="raise", max_groups=256)
    txs, jxs = _executors(plans, 3)
    calls = _count_batched(monkeypatch)
    for r in range(3):
        tch, jch, _ = _round([20 * r + i for i in range(3)], CHUNK, card=200)
        over_t, over_j, _ = _round([99 + r], CHUNK, card=4000, offset=1 << 20)
        tch[1], jch[1] = over_t[0], over_j[0]
        tex.consume_batched(txs, tch)
        jex.consume_batched(jxs, jch)
    assert txs[1]._op.poisoned
    assert calls == [3, 2, 2]  # the poisoned lane is skipped from its next round on
    for i, (tx, jx) in enumerate(zip(txs, jxs)):
        if i == 1:
            with pytest.raises(TOverflow):
                tx.finalize()
            with pytest.raises(JOverflow):
                jx.finalize()
            continue
        _assert_lane_equal(tx, jx)
        _assert_same_map(tx.finalize(), jx.finalize())


@pytest.mark.parametrize("case", ["ragged", "mask"])
def test_consume_batched_ragged_and_masked_rounds_go_lane_by_lane(case, monkeypatch):
    plans = _plans(saturation="raise", max_groups=1024)
    txs, jxs = _executors(plans, 3)
    calls = _count_batched(monkeypatch)
    tch, jch, _ = _round([1, 2, 3], CHUNK)
    tex.consume_batched(txs, tch)
    jex.consume_batched(jxs, jch)
    if case == "ragged":  # a stream's short final chunk
        tch, jch, _ = _round([4, 5, 6], CHUNK)
        short_t, short_j, _ = _round([7], 100)
        tch[2], jch[2] = short_t[0], short_j[0]
    else:
        tch, jch, _ = _round([4, 5, 6], CHUNK, mask=True)
    tex.consume_batched(txs, tch)
    jex.consume_batched(jxs, jch)
    assert calls == [3]  # the second round consumed lane by lane
    for tx, jx in zip(txs, jxs):
        _assert_lane_equal(tx, jx)
        _assert_same_map(tx.finalize(), jx.finalize())


def test_scan_ticket_batched_plain_is_scan_ticket_plain_per_lane():
    from repro_torch.core import ticketing as tk

    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 900, size=(3, 4, 256)).astype(np.int32))
    keys[1, 2, :40] = -1
    caps = (2048, 4096, 2048)
    batched = [tk.make_table(c, 1024) for c in caps]
    solo = [tk.make_table(c, 1024) for c in caps]
    todo = torch.ones((3, 4), dtype=torch.int32)
    th, bs = [c // 2 for c in caps], [1024 - 256] * 3
    tickets, info = tfk.scan_ticket_batched(batched, keys, todo, thresholds=th,
                                            bound_slacks=bs)
    assert tickets.shape == keys.shape and info.shape == (3, tfk.INFO_LEN)
    assert not bool(todo.any())
    for i, t in enumerate(solo):
        one = torch.ones(4, dtype=torch.int32)
        want_t, want_i = tfk.scan_ticket_plain(t, keys[i], one, threshold=th[i],
                                               bound_slack=bs[i])
        assert torch.equal(tickets[i], want_t) and torch.equal(info[i:i + 1], want_i)
        for a, b in zip(batched[i], t):
            assert torch.equal(a, b)


# -- the folding round: ticket and update in the one call --------------------------

AGGS5 = (("sum", "v"), ("count", None), ("min", "v"), ("max", "v"), ("mean", "v"))


def _aggs(api, aggs=AGGS5):
    return tuple(api.AggSpec(k, c) for k, c in aggs)


def _count_rounds(monkeypatch):
    """Count the round's calls (lanes, fold mode) and every
    ``GroupByOperator.update_planes`` call."""
    gb = importlib.import_module("repro_torch.engine.groupby")
    calls, updates = [], []
    real_call, real_update = tfk.scan_ticket_batched, gb.GroupByOperator.update_planes

    def counted(tables, *a, **kw):
        calls.append((len(tables), kw.get("states") is not None))
        return real_call(tables, *a, **kw)

    def update(self, *a, **kw):
        updates.append(self)
        return real_update(self, *a, **kw)

    monkeypatch.setattr(tfk, "scan_ticket_batched", counted)
    monkeypatch.setattr(gb.GroupByOperator, "update_planes", update)
    return calls, updates


def _assert_bits(got, want):
    """Bit for bit, NaN included (a min / max column is NaN past the
    groups)."""
    for col in want.columns:
        a, b = got[col], want[col]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), col


def _plans5(saturation, max_groups=1024, **ex):
    tplan, jplan = _plans(saturation=saturation, max_groups=max_groups)
    tplan = tplan.with_(aggs=_aggs(tapi), execution=tapi.ExecutionPolicy(
        **{**vars(tplan.execution), **ex}))
    jplan = jplan.with_(aggs=_aggs(japi), execution=japi.ExecutionPolicy(
        **{**vars(jplan.execution), **ex}))
    return tplan, jplan


@pytest.mark.parametrize("saturation", ["raise", "unchecked"])
def test_consume_batched_folds_in_its_one_call_equal_to_jax(saturation, monkeypatch):
    """A scatter round folds inside its one ``scan_ticket_batched`` call
    (the plain version of fold mode): no ``update_planes`` call, and every
    lane's table and five accumulator planes (sum, count, min, max, and
    mean's) equal JAX ``consume_batched``'s, ticket for ticket."""
    plans = _plans5(saturation)
    txs, jxs = _executors(plans, 4)
    calls, updates = _count_rounds(monkeypatch)
    for r in range(3):
        tch, jch, _ = _round([30 + 10 * r + i for i in range(4)], CHUNK, card=700)
        tex.consume_batched(txs, tch)
        jex.consume_batched(jxs, jch)
    assert calls == [(4, True)] * 3 and updates == []
    for tx, jx in zip(txs, jxs):
        _assert_lane_equal(tx, jx)
        tout, jout = tx.finalize(), jx.finalize()
        _assert_same_map(tout, jout)
        for col in ("min(v)", "max(v)"):
            assert _map(tout, col) == _map(jout, col), col


def test_consume_batched_fold_round_with_one_overflowing_lane(monkeypatch):
    """RAISE: one lane of a folding round takes 4000 keys against G = 256.
    Only that query is poisoned (it raises at finalize, as JAX's does), it
    drops out of the later rounds, and the other lanes equal JAX's ticket
    for ticket with no ``update_planes`` call."""
    plans = _plans5("raise", max_groups=256)
    txs, jxs = _executors(plans, 3)
    calls, updates = _count_rounds(monkeypatch)
    for r in range(3):
        tch, jch, _ = _round([40 + 20 * r + i for i in range(3)], CHUNK, card=200)
        over_t, over_j, _ = _round([199 + r], CHUNK, card=4000, offset=1 << 20)
        tch[1], jch[1] = over_t[0], over_j[0]
        tex.consume_batched(txs, tch)
        jex.consume_batched(jxs, jch)
    assert txs[1]._op.poisoned and not txs[0]._op.poisoned
    assert calls == [(3, True), (2, True), (2, True)] and updates == []
    for i, (tx, jx) in enumerate(zip(txs, jxs)):
        if i == 1:
            with pytest.raises(TOverflow):
                tx.finalize()
            with pytest.raises(JOverflow):
                jx.finalize()
            continue
        _assert_lane_equal(tx, jx)
        _assert_same_map(tx.finalize(), jx.finalize())


def test_fold_round_pausing_lanes_replay_through_poll(monkeypatch):
    """A capacity of 256 slots under G = 1024: every lane pauses in its
    first round (count > 128), its later morsels fold nothing in the
    batched call and stay todo, and the lane's own ``poll`` migrates and
    replays them through the solo path, which folds.  Each query equals
    its sequential ``collect`` and JAX's as maps (keys, COUNT, MIN and MAX
    exact): a pause orders tickets by when each mode replays, so no two
    modes share a ticket order here."""
    tplan, jplan = _plans5("raise", capacity=256)
    seeds = range(40, 43)
    sequential = [tplan.collect(TArraySource(_tcols(i, card=300), chunk_rows=CHUNK))
                  for i in seeds]
    calls, updates = _count_rounds(monkeypatch)
    server = tqs.AggregationServer(slots=3, batch_queries=True)
    handles = [server.submit(tplan, TArraySource(_tcols(i, card=300), chunk_rows=CHUNK))
               for i in seeds]
    server.run_until_idle()
    assert calls == [(3, True)] * (N // CHUNK)
    assert len(updates) >= 3  # every lane replayed its paused morsels alone
    for i, h, want in zip(seeds, handles, sequential):
        got = h.result()
        jout = jplan.collect(JArraySource(_jcols(i, card=300), chunk_rows=CHUNK))
        for ref in (want, jout):
            _assert_same_map(got, ref, *_np_cols(i, card=300))
            for col in ("min(v)", "max(v)"):
                assert _map(got, col) == _map(ref, col), col


@pytest.mark.parametrize("saturation,aggs", [
    ("raise", AGGS5), ("unchecked", (("min", "v"), ("max", "v"), ("count", None))),
])
def test_batched_fold_server_bit_identical_to_sequential_collect(saturation, aggs,
                                                                 monkeypatch):
    tplan, jplan = _plans5(saturation)
    tplan, jplan = tplan.with_(aggs=_aggs(tapi, aggs)), jplan.with_(aggs=_aggs(japi, aggs))
    seeds = range(50, 55)
    sequential = [tplan.collect(TArraySource(_tcols(i), chunk_rows=CHUNK)) for i in seeds]
    calls, updates = _count_rounds(monkeypatch)
    server = tqs.AggregationServer(slots=5, batch_queries=True)
    handles = [server.submit(tplan, TArraySource(_tcols(i), chunk_rows=CHUNK)) for i in seeds]
    server.run_until_idle()
    assert calls == [(5, True)] * (N // CHUNK) and updates == []
    jserver = jqs.AggregationServer(slots=5, batch_queries=True)
    jhandles = [jserver.submit(jplan, JArraySource(_jcols(i), chunk_rows=CHUNK))
                for i in seeds]
    jserver.run_until_idle()
    for h, want, jh in zip(handles, sequential, jhandles):
        got = h.result()
        _assert_bits(got, want)
        for col in ("min(v)", "max(v)", "count(*)"):
            assert _map(got, col) == _map(jh.result(), col), col


@pytest.mark.parametrize("update", ["onehot", "sort_segment"])
def test_consume_batched_other_updates_ticket_then_fold_per_lane(update, monkeypatch):
    """Rounds whose update is not scatter keep the ticket-only call and
    fold each lane through its own update: N ``update_planes`` calls a
    round, ticket for ticket with JAX."""
    plans = _plans5("raise", update=update)
    txs, jxs = _executors(plans, 3)
    calls, updates = _count_rounds(monkeypatch)
    for r in range(2):
        tch, jch, _ = _round([60 + 10 * r + i for i in range(3)], CHUNK, card=700)
        tex.consume_batched(txs, tch)
        jex.consume_batched(jxs, jch)
    assert calls == [(3, False)] * 2 and len(updates) == 6
    for tx, jx in zip(txs, jxs):
        _assert_lane_equal(tx, jx)
        _assert_same_map(tx.finalize(), jx.finalize())


def test_scan_ticket_batched_plain_fold_is_ticket_then_scatter_per_lane():
    """Fold mode's plain version: each lane's ``scan_ticket_plain`` and then
    ``update_agg_state`` with ``scatter_update``, in lane order, the
    planes updated in place; ``(None, info)`` back; keys as one tensor or
    one per lane."""
    from repro_torch.core import ticketing as tk
    from repro_torch.core import updates as tup

    rng = np.random.default_rng(6)
    keys = torch.from_numpy(rng.integers(0, 900, size=(3, 4, 256)).astype(np.int32))
    keys[2, 1, :50] = -1
    vals = torch.from_numpy(rng.standard_normal((3, 4, 256)).astype(np.float32))
    specs = (("v", "sum"), (None, "count"), ("v", "min"), ("v", "max"))
    caps, g = (2048, 4096, 2048), 1024
    th, bs = [c // 2 for c in caps], [g - 256] * 3
    for as_list in (False, True):
        tables = [tk.make_table(c, g) for c in caps]
        states = [tup.init_agg_state(specs, g) for _ in caps]
        todo = torch.ones((3, 4), dtype=torch.int32)
        values = [{"v": vals[i]} for i in range(3)]
        lane_keys = list(keys) if as_list else keys
        tickets, info = tfk.scan_ticket_batched(tables, lane_keys, todo, thresholds=th,
                                                bound_slacks=bs, states=states,
                                                values=values, specs=specs)
        assert tickets is None and not bool(todo.any())
        for i, c in enumerate(caps):
            t, s = tk.make_table(c, g), tup.init_agg_state(specs, g)
            want_t, want_i = tfk.scan_ticket_plain(t, keys[i], torch.ones(4, dtype=torch.int32),
                                                   threshold=th[i], bound_slack=bs[i])
            tup.update_agg_state(s, want_t.reshape(-1), {"v": vals[i].reshape(-1)},
                                 tup.scatter_update)
            assert torch.equal(info[i:i + 1], want_i)
            for a, b in zip(tables[i], t):
                assert torch.equal(a, b)
            for a, b in zip(states[i].accs, s.accs):
                assert torch.equal(a, b)


# -- eligibility, admission, recovery ----------------------------------------------


@pytest.mark.parametrize("case", [
    {}, {"saturation": "raise"}, {"saturation": "grow"}, {"saturation": "spill"},
    {"max_groups": None}, {"strategy": "partitioned"}, {"strategy": "auto"},
    {"execution": {"kernel": "off"}}, {"execution": {"kernel": "scan_body"}},
    {"execution": {"kernel": "fused"}}, {"execution": {"use_kernel": True}},
    {"execution": {"ticketing": "sort"}}, {"execution": {"pipeline": "host"}},
    {"execution": {"instrument": True}},
])
def test_batch_signature_eligibility_matches_jax(case):
    kw = dict(case)
    ex = kw.pop("execution", {})
    tplan, jplan = _plans(**kw)
    tplan = tplan.with_(execution=tapi.ExecutionPolicy(**{**vars(tplan.execution), **ex}))
    jplan = jplan.with_(execution=japi.ExecutionPolicy(**{**vars(jplan.execution), **ex}))
    tsig, jsig = tex.batch_signature(tplan), jex.batch_signature(jplan)
    assert (tsig is None) == (jsig is None)
    if tsig is not None:
        assert tsig[:-1] == jsig and tsig[-1] == "cpu"


def test_full_queue_refuses_and_cancels_the_stream():
    tplan, _ = _plans()
    server = tqs.AggregationServer(slots=1)
    server.set_budget("t", max_queue_depth=1)
    server.submit(tplan, TArraySource(_tcols(0), chunk_rows=CHUNK), tenant="t")
    server.submit(tplan, TArraySource(_tcols(1), chunk_rows=CHUNK), tenant="t")
    cancelled = []
    real = tapi.StreamHandle.cancel

    def spy(self):
        cancelled.append(self)
        real(self)

    tapi.StreamHandle.cancel = spy
    try:
        with pytest.raises(tsched.QueueFullError):
            server.submit(tplan, TArraySource(_tcols(2), chunk_rows=CHUNK), tenant="t")
    finally:
        tapi.StreamHandle.cancel = real
    assert len(cancelled) == 1 and cancelled[0].cancelled
    assert server.tenant_stats("t")["queued"] == 1


def test_checkpointed_submit_raises_before_taking_a_slot(tmp_path):
    """A checkpointed submit (named from when checkpoints were not ported
    and it raised): the query takes a slot, commits every 2 chunks, and a
    ``WorkerFailure`` at its sixth chunk restores it once from the chunk-4
    commit; it finishes with the uninterrupted query's map, and JAX's."""
    from repro_torch.checkpoint.manager import latest_commit_step

    tplan, jplan = _plans()
    cols = _tcols(0)

    class Flaky:
        failed = False

        def chunks(self):
            for i, chunk in enumerate(TArraySource(cols, chunk_rows=CHUNK).chunks()):
                if i == 5 and not Flaky.failed:
                    Flaky.failed = True
                    raise telastic.WorkerFailure([0])
                yield chunk

    server = tqs.AggregationServer(slots=1)
    q = server.submit(tplan, Flaky(), checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert server.tenant_stats("default")["running"] == 1 and q.slot is not None
    server.step(4)
    assert q.chunks_consumed == 4 and latest_commit_step(str(tmp_path)) == 4
    server.step(2)  # the sixth chunk fails: restored at the chunk-4 commit
    assert Flaky.failed and q.profile()["recoveries"] == {"remeshes": 0, "restores": 1}
    assert q.chunks_consumed == 4
    server.run_until_idle()
    assert q.status == "done" and latest_commit_step(str(tmp_path)) == N // CHUNK
    out = q.result()
    assert _map(out) == _map(tplan.collect(TArraySource(cols, chunk_rows=CHUNK)))
    assert _map(out, "count(*)") == _map(tplan.collect(TArraySource(cols, chunk_rows=CHUNK)),
                                         "count(*)")
    jserver = jqs.AggregationServer(slots=1)
    jq = jserver.submit(jplan, JArraySource(_jcols(0), chunk_rows=CHUNK))
    _assert_same_map(out, jq.result())


def test_worker_failure_without_a_checkpoint_fails_only_its_slot():
    tplan, _ = _plans()
    server = tqs.AggregationServer(slots=2, batch_queries=False)

    def failing():
        yield TTable(_tcols(0))
        telastic.mark_failed([3])
        raise telastic.WorkerFailure(sorted(telastic.failed_ids()))

    try:
        bad = server.submit(tplan, failing(), tenant="a")
        good = server.submit(tplan, TArraySource(_tcols(1), chunk_rows=CHUNK), tenant="b")
        server.run_until_idle()
    finally:
        telastic.reset_failures()
    assert bad.status == "failed" and isinstance(bad.error, telastic.WorkerFailure)
    assert bad.error.device_ids == [3] and telastic.failed_ids() == frozenset()
    assert bad.profile()["recoveries"] == {"remeshes": 0, "restores": 0}
    assert good.status == "done"


def test_batched_step_settles_solo_chunks_in_flight_first():
    """A query stepped alone first (its chunk left in flight, prefetch 2)
    and then batched: its handle's in-flight chunks are polled before the
    batched chunk, and the result is its sequential one, bit for bit."""
    tplan, _ = _plans(saturation="raise", max_groups=512)
    server = tqs.AggregationServer(slots=2)
    first = server.submit(tplan, TArraySource(_tcols(0), chunk_rows=CHUNK), tenant="a")
    server.step(1)  # alone: one solo quantum
    assert len(first._stream._inflight) == 1
    second = server.submit(tplan, TArraySource(_tcols(1), chunk_rows=CHUNK), tenant="b")
    server.step(1)  # both, batched
    assert len(first._stream._inflight) == 0
    server.run_until_idle()
    for h, seed in ((first, 0), (second, 1)):
        _assert_bitwise(h.result(),
                        tplan.collect(TArraySource(_tcols(seed), chunk_rows=CHUNK)))


# -- the package exports (fault 8) -------------------------------------------------


@pytest.mark.parametrize("package", ["core", "engine", "obs", "kernels", "serve"])
def test_every_reference_export_exists_in_the_port(package):
    ref = importlib.import_module(f"repro.{package}" if package != "serve"
                                  else "repro.serve.query_server")
    port = importlib.import_module(f"repro_torch.{package}")
    names = list(ref.__all__)
    if package == "serve":
        names += jsched.__all__
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == []
    if package != "serve":
        assert set(ref.__all__) <= set(port.__all__)


def test_front_door_imports_and_version():
    from repro_torch.core import choose_plan, groupby_oracle  # noqa: F401
    from repro_torch.engine import AggSpec, GroupByPlan, Table  # noqa: F401
    from repro_torch.kernels import fused_groupby, fused_groupby_pallas

    assert fused_groupby_pallas is fused_groupby.fused_groupby
    assert repro_torch.__version__ == repro.__version__
