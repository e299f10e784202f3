"""Multi-device sharding of repro_torch (``parallel/sharding.py``,
``core/distributed.py``, ``_ShardedExecutor``, the sharded half of
``engine/elastic.py``) on the CPU.

The port runs in this process on a single-controller mesh of CPU members
(``virtual_devices(4 or 8, "cpu")``); the JAX package runs in ONE warm
subprocess with ``--xla_force_host_platform_device_count=4`` (the pattern
of tests/test_distributed.py; XLA_FLAGS is never set in this process).
Inputs are made in the test process from seeds with numpy and reach both
sides as the same arrays.

What is held, and how:

* the collectives against numpy;
* the per-member carries ARRAY FOR ARRAY against JAX's after a checked
  step, a grow, the resumed step, an unchecked step that saturates, and a
  re-bucket onto 3 members (the plain GET_OR_INSERT is the reference's
  claim rounds, ticket for ticket), with the halts member for member;
* ``sharded_psum_merge`` array for array and ``sharded_exchange_merge``
  per owner, bucket overflow counts included, on the same carry;
* ``GroupByPlan(strategy="sharded")`` under both merges and all three
  saturation policies as maps against the oracle, and against the JAX
  plan for two of them: a dense_psum plan, and an all_to_all plan
  restored from the port's commit (each JAX plan compiles its own steps
  and merge, about 10 s on a CPU, so the file runs two).  The
  reference's own 1-device all_to_all and grow streams raise on jax 0.9
  (ROADMAP §3 fault 5); their mirrors below are held to the oracle;
* the reference's sharded tests mirrored in-process (test_distributed.py
  :94 and :121, test_plan_api.py:228, test_stream.py:290 and :322,
  test_elastic.py:269, :292 and :310, test_perf_features.py:95 and :104);
* commits both ways: a stream JAX saves on 4 devices restores in the port
  on 4 and on 2 members, and one the port saves on 2 restores in JAX on 4.

The JAX side is ONE request to the worker, sent before the module's first
test: the port's tests run while JAX computes, and the tests that read it
come last.

Tolerance: values are integer-valued float32, so every SUM is exact below
2^24 whatever the fold order; COUNT, MIN and MAX are exact.  Maps are
compared exactly.
"""
import atexit
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as tdist
from repro_torch.core import groupby_oracle
from repro_torch.core.hashing import EMPTY_I32
from repro_torch.engine import elastic as streams
from repro_torch.engine import executors as tex
from repro_torch.engine import plan_api as tapi
from repro_torch.engine.columns import Table
from repro_torch.engine.groupby import GroupByOverflowError
from repro_torch.kernels import fused_groupby as fk
from repro_torch.parallel import sharding
from repro_torch.train import elastic as telastic

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

AggSpec, ExecutionPolicy, GroupByPlan = tapi.AggSpec, tapi.ExecutionPolicy, tapi.GroupByPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ((None, "count"), ("v", "sum"), ("v", "min"), ("v", "max"))
N, CHUNK = 4096, 512

# ---------------------------------------------------------------------------
# the warm JAX worker (copied from tests/test_distributed.py)

_WORKER_LOOP = r"""
import contextlib, io, json, sys, traceback
for line in sys.stdin:
    req = json.loads(line)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(req["code"], "<sharded-test>", "exec"),
                 {"__name__": "__worker__"})
        out = buf.getvalue().strip().splitlines()
        payload = {"out": out[-1] if out else ""}
    except BaseException:
        payload = {"err": traceback.format_exc()[-3000:],
                   "out": buf.getvalue()[-2000:]}
    sys.stdout.write(json.dumps(payload) + "\n")
    sys.stdout.flush()
"""

_WORKERS: dict[int, tuple] = {}


def _get_worker(k: int):
    worker = _WORKERS.get(k)
    if worker is not None and worker[0].poll() is None:
        return worker
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={k}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    errlog = tempfile.NamedTemporaryFile(
        mode="w+", prefix=f"shardworker{k}-", suffix=".log", delete=False
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", _WORKER_LOOP], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=errlog, text=True, env=env,
    )
    _WORKERS[k] = (proc, errlog.name)
    return _WORKERS[k]


@atexit.register
def _shutdown_workers():
    for proc, _ in _WORKERS.values():
        if proc.poll() is None:
            proc.kill()


class JaxJob:
    """One request to the warm worker, sent when made and read when first
    needed: the port's tests run while the worker computes."""

    def __init__(self, k: int, code: str):
        self._k = k
        self._proc, self._errpath = _get_worker(k)
        self._proc.stdin.write(json.dumps({"code": code}) + "\n")
        self._proc.stdin.flush()
        self._reply: dict = {}
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        self._reply["line"] = self._proc.stdout.readline()

    def result(self, timeout: float = 600) -> dict:
        self._reader.join(timeout)
        if not self._reply.get("line"):
            self._proc.kill()
            _WORKERS.pop(self._k, None)
            with open(self._errpath) as f:
                tail = f.read()[-3000:]
            pytest.fail(f"device-count-{self._k} worker hung or died; stderr:\n{tail}")
        payload = json.loads(self._reply["line"])
        assert "err" not in payload, payload.get("err")
        return json.loads(payload["out"])


_JAX_PRELUDE = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import distributed as dist
from repro.engine.plan_api import AggSpec, ExecutionPolicy, GroupByPlan
from repro.engine.columns import Table
IN = dict(np.load(%r))
SPECS = ((None, "count"), ("v", "sum"), ("v", "min"), ("v", "max"))
AGGS = (AggSpec("count"), AggSpec("sum", "v"), AggSpec("min", "v"), AggSpec("max", "v"))
mesh = jax.make_mesh((4,), ("data",))

class Src:
    def __init__(self, keys, vals, chunk=512):
        self.keys, self.vals, self.chunk = keys, vals, chunk
    def chunks(self):
        for i in range(0, len(self.keys), self.chunk):
            yield Table({"k": jnp.asarray(self.keys[i:i + self.chunk]),
                         "v": jnp.asarray(self.vals[i:i + self.chunk])})

def plan_on(devs, merge="dense_psum", sat="grow", max_groups=512, aggs=AGGS):
    return GroupByPlan(keys=("k",), aggs=aggs, strategy="sharded", max_groups=max_groups,
                       saturation=sat, raw_keys=True,
                       execution=ExecutionPolicy(mesh=Mesh(np.asarray(devs), ("data",)),
                                                 shard_merge=merge))

def tmaps(out):
    n = int(np.asarray(out["__num_groups__"])[0])
    keys = np.asarray(out["key"])[:n].tolist()
    return {c: dict(zip(map(str, keys), np.asarray(out[c])[:n].tolist()))
            for c in ("count(*)", "sum(v)", "min(v)", "max(v)") if c in out.columns}
"""


# ---------------------------------------------------------------------------
# helpers


@pytest.fixture(autouse=True)
def _clean_mesh_state():
    yield
    sharding.reset_virtual_devices()
    telastic.reset_failures()


def cpu_members(n: int) -> list:
    return [sharding.MeshDevice(i, torch.device("cpu")) for i in range(n)]


def cpu_mesh(n: int) -> sharding.Mesh:
    return sharding.make_mesh((n,), ("data",), devices=cpu_members(n))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


class Src:
    """A re-iterable chunk source of (k, v) arrays."""

    def __init__(self, keys, vals, chunk=CHUNK):
        self.keys, self.vals, self.chunk = keys, vals, chunk

    def chunks(self):
        for i in range(0, len(self.keys), self.chunk):
            yield Table({"k": _t(self.keys[i:i + self.chunk]),
                         "v": _t(self.vals[i:i + self.chunk])})


AGGS = (AggSpec("count"), AggSpec("sum", "v"), AggSpec("min", "v"), AggSpec("max", "v"))
COLS = ("count(*)", "sum(v)", "min(v)", "max(v)")


def plan_on(mesh, merge="dense_psum", sat="grow", max_groups=512, aggs=AGGS, **ex):
    return GroupByPlan(keys=("k",), aggs=aggs, strategy="sharded", max_groups=max_groups,
                       saturation=sat, raw_keys=True,
                       execution=ExecutionPolicy(mesh=mesh, shard_merge=merge, **ex))


def tmaps(out) -> dict:
    n = int(out["__num_groups__"][0])
    keys = out["key"][:n].tolist()
    return {c: dict(zip(map(str, keys), out[c][:n].tolist()))
            for c in COLS if c in out.columns}


def oracle_maps(keys, vals) -> dict:
    out = {}
    for col, kind in zip(COLS, ("count", "sum", "min", "max")):
        ref = groupby_oracle(_t(keys), _t(vals), kind=kind, max_groups=len(keys))
        n = int(ref.num_groups)
        out[col] = dict(zip(map(str, ref.keys[:n].tolist()), ref.values[:n].tolist()))
    return out


def stream_data(seed=5, card=300):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, card, N).astype(np.uint32)
    keys[::7] += np.uint32(1 << 31)  # keys past 2^31: negative int32 bit patterns
    return keys, rng.integers(0, 100, N).astype(np.float32)


# ---------------------------------------------------------------------------
# the mesh seam


def test_make_mesh_shape_members_and_virtual_devices():
    with sharding.virtual_devices(8, "cpu") as devs:
        assert [d.id for d in devs] == list(range(8))
        assert all(d.device == torch.device("cpu") for d in devs)
        mesh = sharding.make_mesh((4, 2), ("data", "model"))
        assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
        assert [d.id for d in mesh.members("data")] == [0, 2, 4, 6]
        assert [d.id for d in mesh.members("model")] == [0, 1]
        with sharding.virtual_devices(2, "cpu"):
            assert len(sharding.devices()) == 2
        assert len(sharding.devices()) == 8
    sharding.virtual_devices(3, "cpu")  # the setter form
    assert len(sharding.devices()) == 3
    sharding.reset_virtual_devices()
    with pytest.raises(ValueError, match="needs 4 devices"):
        sharding.make_mesh((4,), ("data",), devices=cpu_members(3))
    with pytest.raises(ValueError, match="repeats"):
        sharding.Mesh(np.asarray(cpu_members(2) * 2, dtype=object), ("data",))


def test_virtual_devices_default_to_the_card(monkeypatch):
    """Without a device, mesh members go on the card, as the port's other
    entry points do: where there is none, ``virtual_devices(n)`` raises
    and leaves the setting as it was instead of placing them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with sharding.virtual_devices(2, "cpu"):
        with pytest.raises(RuntimeError, match="no CUDA"):
            sharding.virtual_devices(2)
        assert [d.device for d in sharding.devices()] == [torch.device("cpu")] * 2
    sharding.reset_virtual_devices()
    with pytest.raises(RuntimeError, match="no CUDA"):
        sharding.virtual_devices(2)


def test_cuda_members_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        sharding.virtual_devices(2, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.devices()
    # an explicit device must be the members'
    plan = plan_on(cpu_mesh(2), device="cuda")
    with pytest.raises(ValueError, match="disagrees"):
        tex.make_executor(plan)


def _members_tensors(rng, n, shape, dtype=np.float32):
    return [torch.from_numpy(rng.normal(size=shape).astype(dtype)) for _ in range(n)]


@pytest.mark.parametrize("op", ["shard", "all_gather", "gather", "psum", "pmin", "pmax",
                                "all_to_all"])
def test_collectives_against_numpy(op):
    rng = np.random.default_rng(3)
    members = cpu_members(4)
    xs = _members_tensors(rng, 4, (4, 3))
    np_xs = [x.numpy().copy() for x in xs]
    if op == "shard":
        x = torch.arange(24.0).reshape(8, 3)
        parts = sharding.shard(x, members)
        assert [p.shape for p in parts] == [(2, 3)] * 4
        np.testing.assert_array_equal(np.concatenate([p.numpy() for p in parts]), x.numpy())
        with pytest.raises(ValueError, match="do not split"):
            sharding.shard(torch.zeros(5), members)
    elif op == "all_gather":
        outs = sharding.all_gather(xs, members)
        for o in outs:
            np.testing.assert_array_equal(o.numpy(), np.concatenate(np_xs))
        outs[0][0, 0] = 99.0  # each member's result is its own
        assert outs[1][0, 0] != 99.0 and xs[0][0, 0] != 99.0
    elif op == "gather":
        np.testing.assert_array_equal(sharding.gather(xs, members[2]).numpy(),
                                      np.concatenate(np_xs))
    elif op in ("psum", "pmin", "pmax"):
        out = getattr(sharding, op)(xs, members[0])
        want = {"psum": np.sum, "pmin": np.min, "pmax": np.max}[op](np.stack(np_xs), axis=0)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
        out.add_(1.0)  # a fresh tensor: member 0's own is untouched
        np.testing.assert_array_equal(xs[0].numpy(), np_xs[0])
    else:
        outs = sharding.all_to_all(xs, members)
        for j, o in enumerate(outs):
            np.testing.assert_array_equal(o.numpy(), np.stack([x[j] for x in np_xs]))


# ---------------------------------------------------------------------------
# the reference's sharded tests, mirrored in-process


@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
def test_concurrent_sharded_matches_oracle(kind):
    # tests/test_distributed.py:94 on 8 members
    sharding.virtual_devices(8, "cpu")
    mesh = sharding.make_mesh((8,), ("data",))
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 200, size=8192).astype(np.uint32)
    vals = rng.normal(size=8192).astype(np.float32)
    ref = groupby_oracle(_t(keys), _t(vals), kind=kind, max_groups=256)
    got = tdist.concurrent_groupby_sharded(mesh, _t(keys), _t(vals), kind=kind, max_groups=256)
    n, m = int(ref.num_groups), int(got.num_groups)
    rm = dict(zip(ref.keys[:n].tolist(), ref.values[:n].tolist()))
    gm = dict(zip(got.keys[:m].tolist(), got.values[:m].tolist()))
    assert rm.keys() == gm.keys() and all(abs(rm[k] - gm[k]) < 1e-2 for k in rm)


def test_partitioned_sharded_all_to_all():
    # tests/test_distributed.py:121 on 8 members
    sharding.virtual_devices(8, "cpu")
    mesh = sharding.make_mesh((8,), ("data",))
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 200, size=8192).astype(np.uint32)
    vals = rng.normal(size=8192).astype(np.float32)
    keys_p, vals_p, counts_p, ovf = tdist.partitioned_groupby_sharded(
        mesh, _t(keys), _t(vals), kind="sum", max_groups=256, preagg_capacity=512)
    assert int(ovf.sum()) == 0
    kp, vp = keys_p.reshape(8, -1), vals_p.reshape(8, -1)
    got = {}
    for d in range(8):
        c = int(counts_p[d])
        for k, v in zip(kp[d][:c].tolist(), vp[d][:c].tolist()):
            assert k not in got
            got[k] = v
    ref = groupby_oracle(_t(keys), _t(vals), kind="sum", max_groups=256)
    n = int(ref.num_groups)
    rm = dict(zip(ref.keys[:n].tolist(), ref.values[:n].tolist()))
    assert rm.keys() == got.keys() and all(abs(rm[k] - got[k]) < 1e-2 for k in rm)


def test_legacy_sharded_shims_single_member_mesh():
    # tests/test_plan_api.py:228
    mesh = cpu_mesh(1)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 200, size=2048).astype(np.uint32)
    vals = rng.normal(size=2048).astype(np.float32)
    ref = groupby_oracle(_t(keys), _t(vals), kind="sum", max_groups=256)
    want = dict(zip(ref.keys[:int(ref.num_groups)].tolist(),
                    ref.values[:int(ref.num_groups)].tolist()))
    got = tdist.concurrent_groupby_sharded(mesh, _t(keys), _t(vals), kind="sum", max_groups=256)
    n = int(got.num_groups)
    gm = dict(zip(got.keys[:n].tolist(), got.values[:n].tolist()))
    assert gm.keys() == want.keys() and all(abs(gm[k] - want[k]) < 1e-2 for k in want)
    keys_p, vals_p, counts_p, ovf = tdist.partitioned_groupby_sharded(
        mesh, _t(keys), _t(vals), kind="sum", max_groups=256, preagg_capacity=512)
    assert int(ovf.sum()) == 0
    cnt = int(counts_p.reshape(-1)[0])
    pm = dict(zip(keys_p[:cnt].tolist(), vals_p[:cnt].tolist()))
    assert pm.keys() == want.keys() and all(abs(pm[k] - want[k]) < 1e-2 for k in want)


@pytest.mark.parametrize("merge", ["dense_psum", "all_to_all"])
def test_sharded_stream_multi_aggregate(merge):
    # tests/test_stream.py:290 (its all_to_all case fails in JAX: fault 5)
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 500, size=N).astype(np.uint32)
    vals = rng.normal(size=N).astype(np.float32)
    plan = GroupByPlan(
        keys=("k",), aggs=(AggSpec("sum", "v"), AggSpec("mean", "v"), AggSpec("count"),
                           AggSpec("min", "v")),
        strategy="sharded", max_groups=512, saturation="unchecked", raw_keys=True,
        execution=ExecutionPolicy(mesh=cpu_mesh(1), axis="data", shard_merge=merge))
    h = plan.stream(Src(keys, vals))
    out = h.result()
    assert h.peak_buffered_chunks == 0
    n = int(out["__num_groups__"][0])
    k = out["key"][:n].tolist()
    sums = {a: b for a, b in zip(k, out["sum(v)"][:n].tolist())}
    ref_s = groupby_oracle(_t(keys), _t(vals), kind="sum", max_groups=N)
    ref_c = groupby_oracle(_t(keys), None, kind="count", max_groups=N)
    ref_m = groupby_oracle(_t(keys), _t(vals), kind="min", max_groups=N)
    m = int(ref_s.num_groups)
    rs = dict(zip(ref_s.keys[:m].tolist(), ref_s.values[:m].tolist()))
    rc = dict(zip(ref_c.keys[:m].tolist(), ref_c.values[:m].tolist()))
    rmin = dict(zip(ref_m.keys[:m].tolist(), ref_m.values[:m].tolist()))
    assert dict(zip(k, out["count(*)"][:n].tolist())) == rc
    assert sums == pytest.approx(rs, abs=1e-3)
    assert dict(zip(k, out["min(v)"][:n].tolist())) == pytest.approx(rmin, abs=1e-5)
    assert dict(zip(k, out["mean(v)"][:n].tolist())) == pytest.approx(
        {a: rs[a] / rc[a] for a in rs}, abs=1e-4)


def test_sharded_stream_multi_aggregate_grow():
    # tests/test_stream.py:322 (fails in JAX: fault 5)
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 700, size=N).astype(np.uint32)
    vals = rng.normal(size=N).astype(np.float32)
    plan = GroupByPlan(
        keys=("k",), aggs=(AggSpec("mean", "v"), AggSpec("count")), strategy="sharded",
        max_groups=64, saturation="grow", raw_keys=True,
        execution=ExecutionPolicy(mesh=cpu_mesh(1), axis="data"))
    h = plan.stream(Src(keys, vals))
    out = h.result()
    n = int(out["__num_groups__"][0])
    k = out["key"][:n].tolist()
    ref_s = groupby_oracle(_t(keys), _t(vals), kind="sum", max_groups=N)
    ref_c = groupby_oracle(_t(keys), None, kind="count", max_groups=N)
    m = int(ref_s.num_groups)
    rs = dict(zip(ref_s.keys[:m].tolist(), ref_s.values[:m].tolist()))
    rc = dict(zip(ref_c.keys[:m].tolist(), ref_c.values[:m].tolist()))
    assert dict(zip(k, out["count(*)"][:n].tolist())) == rc
    assert dict(zip(k, out["mean(v)"][:n].tolist())) == pytest.approx(
        {a: rs[a] / rc[a] for a in rs}, abs=1e-4)
    assert h.executor.bound_grows >= 1 and h.executor.migrations >= 1


@pytest.mark.parametrize("kill_k,at_chunk", [(1, 2), (2, 4), (3, 6)])
def test_kill_k_devices_mid_stream(kill_k, at_chunk):
    # tests/test_elastic.py:269
    keys, vals = stream_data()
    devs = sharding.virtual_devices(4, "cpu").__enter__()
    oracle = oracle_maps(keys, vals)
    h = plan_on(sharding.make_mesh((4,), ("data",))).stream(Src(keys, vals))
    h.pump(at_chunk)
    telastic.mark_failed([d.id for d in devs[-kill_k:]])
    assert streams.stream_mesh(h).size == 4
    assert streams.mesh_failed_ids(streams.stream_mesh(h)) == [d.id for d in devs[-kill_k:]]
    assert streams.remesh_stream(h)       # loss detected -> re-bucketed
    assert not streams.remesh_stream(h)   # idempotent: the survivors are healthy
    assert streams.stream_mesh(h).size == 4 - kill_k
    assert tmaps(h.result()) == oracle
    assert h.executor.remeshes == 1


def test_total_loss_raises_worker_failure():
    mesh = cpu_mesh(2)
    telastic.mark_failed([0, 1])
    with pytest.raises(telastic.WorkerFailure):
        streams.survivor_mesh(mesh)


@pytest.mark.parametrize("save_n,restore_n", [(4, 2), (2, 4)])
def test_restore_on_different_device_count(save_n, restore_n, tmp_path):
    # tests/test_elastic.py:292
    keys, vals = stream_data()
    h = plan_on(cpu_mesh(save_n)).stream(Src(keys, vals))
    h.pump(5 if save_n == 4 else 3)
    h.save(str(tmp_path))
    restored = plan_on(cpu_mesh(restore_n)).restore(str(tmp_path), Src(keys, vals))
    assert restored.executor._ndev == restore_n
    assert tmaps(restored.result()) == oracle_maps(keys, vals)


def test_server_remeshes_sharded_slot_while_others_step():
    # tests/test_elastic.py:310
    from repro_torch.serve.query_server import AggregationServer

    keys, vals = stream_data()
    oracle = oracle_maps(keys, vals)
    devs = sharding.virtual_devices(4, "cpu").__enter__()
    server = AggregationServer(slots=4)
    flat = GroupByPlan(keys=("k",), aggs=AGGS, strategy="concurrent", max_groups=512,
                       raw_keys=True, saturation="grow", execution=ExecutionPolicy(device="cpu"))
    q_sharded = server.submit(plan_on(sharding.make_mesh((4,), ("data",))), Src(keys, vals),
                              tenant="meshy")
    q_flat = server.submit(flat, Src(keys, vals), tenant="flat")
    server.step(3)
    telastic.mark_failed([devs[-1].id])
    assert tmaps(q_sharded.result()) == oracle
    assert tmaps(q_flat.result()) == oracle
    assert q_sharded.profile()["recoveries"]["remeshes"] == 1
    assert q_flat.profile()["recoveries"]["remeshes"] == 0


def test_elastic_largest_mesh():
    # tests/test_perf_features.py:95
    sharding.virtual_devices(1, "cpu")
    mesh = telastic.largest_mesh(sharding.devices(), model_parallel=1)
    assert mesh.shape == {"data": 1, "model": 1}


def test_elastic_remesh_after_failure():
    # tests/test_perf_features.py:104, in-process on 8 members
    sharding.virtual_devices(8, "cpu")
    devs = sharding.devices()
    m1 = telastic.largest_mesh(telastic.available_devices(), 2)
    telastic.mark_failed([d.id for d in devs[6:]])  # lose 2 devices
    m2 = telastic.remesh(2)
    assert m1.shape == {"data": 4, "model": 2}
    assert m2.shape == {"data": 3, "model": 2}
    assert {d.id for d in m2.devices.reshape(-1)} == set(range(6))


# ---------------------------------------------------------------------------
# the executor's contract


def test_sharded_plan_validation():
    base = dict(keys=("k",), aggs=AGGS, strategy="sharded", max_groups=64, raw_keys=True)
    with pytest.raises(ValueError, match="requires ExecutionPolicy.mesh"):
        tex.make_executor(GroupByPlan(**base, execution=ExecutionPolicy()))
    with pytest.raises(ValueError, match="unknown shard_merge"):
        tex.make_executor(GroupByPlan(**base, execution=ExecutionPolicy(
            mesh=cpu_mesh(2), shard_merge="ring")))
    # an explicit device equal to the members' is accepted
    ex = tex.make_executor(GroupByPlan(**base, execution=ExecutionPolicy(
        mesh=cpu_mesh(2), device="cpu")))
    assert type(ex).__name__ == "_ShardedExecutor"


@pytest.mark.parametrize("merge", ["dense_psum", "all_to_all"])
def test_raise_surfaces_a_local_overflow(merge):
    keys, vals = stream_data(card=2000)
    plan = plan_on(cpu_mesh(4), merge, "raise", 4096, max_local_groups=64)
    with pytest.raises(GroupByOverflowError, match="per-device table"):
        plan.collect(Src(keys, vals))


def test_raise_surfaces_union_and_bucket_overflow():
    keys, vals = stream_data()  # about 550 distinct keys
    with pytest.raises(GroupByOverflowError, match="max_groups=400"):
        plan_on(cpu_mesh(4), "dense_psum", "raise", 400, max_local_groups=1024).collect(
            Src(keys, vals))
    with pytest.raises(GroupByOverflowError, match="bucket overflow"):
        plan_on(cpu_mesh(4), "all_to_all", "raise", 1024, partition_capacity=16).collect(
            Src(keys, vals))
    # GROW doubles the buckets and re-runs the exchange over the carry
    out = plan_on(cpu_mesh(4), "all_to_all", "grow", 1024, partition_capacity=16).collect(
        Src(keys, vals))
    assert tmaps(out) == oracle_maps(keys, vals)


def test_grow_at_the_union_jumps_to_the_issued_count():
    keys, vals = stream_data()  # about 550 distinct keys, in a 1024-slot union
    h = plan_on(cpu_mesh(4), "dense_psum", "grow", 400, max_local_groups=1024).stream(
        Src(keys, vals))
    out = h.result()
    n = len(np.unique(keys))
    assert int(out["__num_groups__"][0]) == n and h.executor._max_groups == n
    assert tmaps(out) == oracle_maps(keys, vals)


@pytest.mark.parametrize("merge", ["dense_psum", "all_to_all"])
def test_legacy_raw_layouts_and_snapshots(merge):
    keys, vals = stream_data()
    plan = plan_on(cpu_mesh(4), merge, "raise", 1024, aggs=(AggSpec("sum", "v"),))
    h = plan.stream(Src(keys, vals))
    h.pump(3)
    snap = tmaps(h.snapshot())
    assert tmaps(h.snapshot()) == snap  # idempotent, and consume goes on
    out = h.result()
    raw = h.executor.raw
    if merge == "dense_psum":
        assert int(raw.num_groups) == int(out["__num_groups__"][0])
    else:
        keys_p, vals_p, counts_p, ovf_p = raw
        assert counts_p.shape == (4,) and ovf_p.shape == (4,) and int(ovf_p.sum()) == 0
        assert vals_p.shape == (4 * 1024,)
        assert int(counts_p.sum()) == int(out["__num_groups__"][0])
    assert tmaps(out)["sum(v)"] == oracle_maps(keys, vals)["sum(v)"]


def test_counters_and_device_bytes():
    keys, vals = stream_data(card=2000)
    plan = plan_on(cpu_mesh(4), "dense_psum", "grow", 4096, max_local_groups=64,
                   instrument=True)
    h = plan.stream(Src(keys, vals))
    h.pump(4)
    telastic.mark_failed([3])
    assert streams.remesh_stream(h)
    out = h.result()
    ex = h.executor
    ev = ex.event_counts()
    assert ev["rows"] == N
    assert ev["migrations"] == ex.migrations >= 1 and ev["bound_grows"] == ex.bound_grows >= 1
    assert ev["remeshes"] == 1
    assert ev["num_groups"] == sum(int(t.count) for t in ex._carry.tables)
    assert ev["table_capacity"] == ex._carry.capacity * 3
    assert ex.device_table_bytes() == ex._carry.nbytes() > 0
    assert h.stats()["device"]["remeshes"] == 1
    assert tmaps(out) == oracle_maps(keys, vals)


def test_estimated_bound_resolves_to_the_sharded_plan():
    keys, vals = stream_data()
    plan = GroupByPlan(keys=("k",), aggs=AGGS, strategy="sharded", raw_keys=True,
                       execution=ExecutionPolicy(mesh=cpu_mesh(2)))
    h = plan.stream(Src(keys, vals))
    out = h.result()
    assert type(h.executor._inner).__name__ == "_ShardedExecutor"
    assert tmaps(out) == oracle_maps(keys, vals)


def test_step_skips_no_member_and_keeps_empty_rows_out():
    """A zero-row chunk and a chunk smaller than the mesh consume cleanly;
    EMPTY keys never become groups."""
    mesh = cpu_mesh(4)
    plan = plan_on(mesh, "dense_psum", "grow", 64)
    keys = np.array([3, 0xFFFFFFFF, 3, 9, 0x80000001], np.uint32)
    vals = np.array([1, 2, 3, 4, 5], np.float32)
    chunks = [Table({"k": _t(keys[:0]), "v": _t(vals[:0])}), Table({"k": _t(keys), "v": _t(vals)})]
    out = tmaps(plan.collect(chunks))
    assert out["count(*)"] == {"3": 2, "9": 1, str(0x80000001): 1}
    assert out["sum(v)"] == {"3": 4.0, "9": 4.0, str(0x80000001): 5.0}
    assert str(EMPTY_I32 & 0xFFFFFFFF) not in out["count(*)"]


# ---------------------------------------------------------------------------
# against JAX: ONE job in the warm worker, sent before the first test of
# the module and read by the tests below, which come last


def _carry_inputs():
    rng = np.random.default_rng(7)
    km = rng.integers(0, 600, (4, 8, 64)).astype(np.uint32)
    km[:, :, -3:] = 0xFFFFFFFF
    km[:, ::3, 5] += np.uint32(1 << 31)
    return km, rng.integers(0, 50, (4, 8, 64)).astype(np.float32)


# the plans JAX runs (each JAX plan compiles its own steps and merge,
# about 10 s apiece on a CPU): dense_psum here, all_to_all as the JAX restore
# of the port's commit; every case is held to the oracle
JAX_PLAN_CASES = (("dense_psum", "raise"),)
JAX_PLAN_AGGS = (AggSpec("sum", "v"), AggSpec("count"))

_JAX_JOB = r"""
km, vm = jnp.asarray(IN["km"]), {"v": jnp.asarray(IN["v"])}
out, res = {}, {}
def save(tag, c):
    c = jax.device_get(c)
    for f in ("keys", "tickets", "kbt", "count", "ovf"):
        out[f"{tag}/{f}"] = np.asarray(getattr(c, f))
    for i, a in enumerate(c.acc.accs):
        out[f"{tag}/acc{i}"] = np.asarray(a)
host = lambda c: jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), c)
step = dist.make_sharded_consume_step(mesh, "data", update="scatter", load_factor=0.5,
                                      checked=True)
c, h = step(dist.make_sharded_carry(4, 64, SPECS), km, vm, jnp.zeros((4,), jnp.int32))
save("checked", c); out["checked/halts"] = np.asarray(h)
firsts = [int(np.flatnonzero(r)[0]) if r.any() else 8 for r in np.asarray(h)]
c = dist.grow_sharded_carry(host(c), 256, 1024)  # host arrays: fault 5's gather
save("grow", c)
c, h = step(c, km, vm, jnp.asarray(firsts, jnp.int32))
save("resume", c); out["resume/halts"] = np.asarray(h)
# the merges under jit: eager shard_map dispatches op by op (~10 s apiece)
r = jax.jit(lambda c: dist.sharded_psum_merge(mesh, "data", c, max_groups=512))(c)
out["psum/kbt"], out["psum/count"], out["psum/lovf"], out["psum/govf"] = (
    np.asarray(x) for x in (r[0], r[2], r[3], r[4]))
for i, a in enumerate(r[1].accs):
    out[f"psum/acc{i}"] = np.asarray(a)
r = jax.jit(lambda c: dist.sharded_exchange_merge(mesh, "data", c, max_groups=512,
                                                  partition_capacity=8))(c)
out["x/keys"], out["x/counts"], out["x/ovf"], out["x/lovf"] = (
    np.asarray(x) for x in (r[0], r[2], r[3], r[4]))
for i, a in enumerate(r[1]):
    out[f"x/acc{i}"] = np.asarray(a)
rb, ml = dist.rebucket_sharded_carry(host(c), 3, max_local=64)
save("rebucket3", rb); out["rebucket3/max_local"] = np.asarray(ml)
un = dist.make_sharded_consume_step(mesh, "data", update="scatter", load_factor=0.5,
                                    checked=False)
c, _ = un(dist.make_sharded_carry(4, 64, SPECS, capacity=64), km, vm,
          jnp.zeros((4,), jnp.int32))
save("unchecked", c)
np.savez(P["carries"], **out)
A2 = (AggSpec("sum", "v"), AggSpec("count"))
for merge, sat in P["plans"]:
    res[f"{merge}/{sat}"] = tmaps(plan_on(jax.devices(), merge, sat, 2048, aggs=A2)
                                  .collect(Src(IN["keys"], IN["vals"])))
h = plan_on(jax.devices(), aggs=A2).stream(Src(IN["ckeys"], IN["cvals"]))
h.pump(5)
h.save(P["jax_commit"])
res["port_commit"] = tmaps(plan_on(jax.devices(), "all_to_all", aggs=A2)
                           .restore(P["port_commit"], Src(IN["ckeys"], IN["cvals"])).result())
print(json.dumps(res))
"""


class JaxReference:
    """What the JAX package computed on the module's inputs, and those
    inputs: the carry sequence, the plans of ``JAX_PLAN_CASES``, a commit
    it saved, and its restore of a commit the port saved on 2 members."""

    def __init__(self, d):
        self.km, self.vm = _carry_inputs()
        self.keys, self.vals = stream_data(11, card=700)
        self.ckeys, self.cvals = stream_data(9, card=500)
        self.jax_commit, self.port_commit = str(d / "jax_commit"), str(d / "port_commit")
        self._carries = str(d / "carries.npz")
        # the port's commit, on 2 members, 4 chunks in
        h = plan_on(cpu_mesh(2), aggs=JAX_PLAN_AGGS, max_local_groups=64).stream(
            Src(self.ckeys, self.cvals))
        h.pump(4)
        h.save(self.port_commit)
        inputs = str(d / "in.npz")
        np.savez(inputs, km=self.km, v=self.vm, keys=self.keys, vals=self.vals,
                 ckeys=self.ckeys, cvals=self.cvals)
        params = {"carries": self._carries, "plans": JAX_PLAN_CASES,
                  "jax_commit": self.jax_commit, "port_commit": self.port_commit}
        self._job = JaxJob(4, _JAX_PRELUDE % inputs + f"P = {params!r}\n" + _JAX_JOB)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            self._res = self._job.result()
            self._res["carries"] = dict(np.load(self._carries))
        return self._res


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    return JaxReference(tmp_path_factory.mktemp("jax"))


def _stacked_of(c, tag, out):
    s = c.stacked()
    for f in ("keys", "tickets", "kbt", "count", "ovf"):
        out[f"{tag}/{f}"] = s[f]
    for i, a in enumerate(s["acc"]):
        out[f"{tag}/acc{i}"] = a


def _halts(infos, nm) -> list:
    rows = [i[0].tolist() for i in infos]
    return [r[fk.INFO_FIRST_HALT] if r[fk.INFO_HALTED] else nm for r in rows]


def _jax_firsts(h) -> list:
    return [int(np.flatnonzero(r)[0]) if r.any() else h.shape[1] for r in h]


@pytest.fixture(scope="module")
def carries(jax_ref):
    """The port through the JAX job's carry sequence; returns (jax arrays,
    port arrays)."""
    km, vm_np = jax_ref.km, jax_ref.vm
    mesh = cpu_mesh(4)
    kms = [torch.from_numpy(km[i].view(np.int32).copy()) for i in range(4)]
    vms = [{"v": torch.from_numpy(vm_np[i].copy())} for i in range(4)]
    out = {}
    step = tdist.make_sharded_consume_step(mesh, "data", update="scatter", load_factor=0.5,
                                           checked=True)
    todo = [fk.todo_from_start(1, 8, 0) for _ in range(4)]
    c, infos = step(tdist.make_sharded_carry(mesh, 64, SPECS), kms, vms, todo)
    _stacked_of(c, "checked", out)
    out["checked/firsts"] = _halts(infos, 8)
    c = tdist.grow_sharded_carry(c, 256, 1024)
    _stacked_of(c, "grow", out)
    todo = [fk.todo_from_start(1, 8, f) for f in out["checked/firsts"]]
    c, infos = step(c, kms, vms, todo)
    _stacked_of(c, "resume", out)
    out["resume/firsts"] = _halts(infos, 8)
    out["psum"] = tdist.sharded_psum_merge(mesh, "data", c, max_groups=512)
    out["x"] = tdist.sharded_exchange_merge(mesh, "data", c, max_groups=512,
                                            partition_capacity=8)
    rb, ml = tdist.rebucket_sharded_carry(c, cpu_members(3), max_local=64)
    _stacked_of(rb, "rebucket3", out)
    out["rebucket3/max_local"] = ml
    un = tdist.make_sharded_consume_step(mesh, "data", update="scatter", load_factor=0.5,
                                         checked=False)
    c, _ = un(tdist.make_sharded_carry(mesh, 64, SPECS, capacity=64), kms, vms,
              [fk.todo_from_start(1, 8, 0) for _ in range(4)])
    _stacked_of(c, "unchecked", out)
    out["upsum"] = tdist.sharded_psum_merge(mesh, "data", c, max_groups=512)
    return jax_ref.result()["carries"], out


def _assert_carry_equal(ref, out, tag):
    for f in ("keys", "tickets", "kbt", "count", "ovf", "acc0", "acc1", "acc2", "acc3"):
        want, got = ref[f"{tag}/{f}"], out[f"{tag}/{f}"]
        assert got.dtype == want.dtype, (tag, f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag}/{f}")


@pytest.mark.parametrize("stage", ["checked", "grow", "resume", "unchecked", "rebucket3"])
def test_carries_array_for_array_against_jax(carries, stage):
    ref, out = carries
    _assert_carry_equal(ref, out, stage)
    if stage == "checked":
        firsts = _jax_firsts(ref["checked/halts"])
        assert out["checked/firsts"] == firsts
        assert all(f < 8 for f in firsts)  # every member paused mid-chunk
    if stage == "resume":
        # the grown bound's headroom is crossed again at morsel 4 on every member
        assert out["resume/firsts"] == _jax_firsts(ref["resume/halts"]) == [4] * 4
    if stage == "unchecked":
        assert ref["unchecked/ovf"].all()  # the saturated tables dropped rows
    if stage == "rebucket3":
        assert out["rebucket3/max_local"] == int(ref["rebucket3/max_local"])
        assert out["rebucket3/keys"].shape[0] == 3


def test_psum_merge_array_for_array_against_jax(carries):
    ref, out = carries
    kbt, state, count, lovf, govf = out["psum"]
    np.testing.assert_array_equal(kbt.numpy().view(np.uint32), ref["psum/kbt"])
    assert int(count) == int(ref["psum/count"]) and int(lovf) == int(ref["psum/lovf"]) == 0
    assert bool(govf) == bool(ref["psum/govf"]) is False
    for i, a in enumerate(state.accs):
        np.testing.assert_array_equal(a.numpy(), ref[f"psum/acc{i}"])
    # the unchecked carry: every member's loss flag reaches the merge
    _, _, _, lovf, _ = out["upsum"]
    assert int(lovf) == int(ref["unchecked/ovf"].sum()) == 4


def test_exchange_merge_per_owner_against_jax(carries):
    ref, out = carries
    keys_p, vals_p, counts_p, overflow_p, lovf = out["x"]
    per_keys = ref["x/keys"].shape[0] // 4
    per_vals = ref["x/acc0"].shape[0] // 4
    assert [int(c) for c in counts_p] == ref["x/counts"].tolist()
    assert [int(o) for o in overflow_p] == ref["x/ovf"].tolist()
    assert sum(ref["x/ovf"].tolist()) > 0  # partition_capacity=8 drops entries
    assert int(lovf) == int(ref["x/lovf"])
    for j in range(4):
        n = int(counts_p[j])
        want_k = ref["x/keys"][j * per_keys:j * per_keys + n]
        np.testing.assert_array_equal(keys_p[j][:n].numpy().view(np.uint32), want_k)
        for s in range(4):
            want = dict(zip(want_k.tolist(),
                            ref[f"x/acc{s}"][j * per_vals:j * per_vals + n].tolist()))
            got = dict(zip(want_k.tolist(), vals_p[s][j][:n].tolist()))
            assert got == want, (j, s)


PLAN_CASES = [(m, s) for m in ("dense_psum", "all_to_all") for s in ("raise", "grow", "unchecked")]


@pytest.mark.parametrize("merge,sat", PLAN_CASES)
def test_sharded_plans_against_the_oracle_and_jax(jax_ref, merge, sat):
    """Every case against the oracle; the cases of ``JAX_PLAN_CASES``
    against the JAX plan too (its sum and count columns)."""
    keys, vals = jax_ref.keys, jax_ref.vals
    # 1097 distinct keys: raise and unchecked under a bound of 2048; grow
    # from a bound of 64, which grows every member's table and the union's
    plan = plan_on(cpu_mesh(4), merge, sat, 1024 if sat == "grow" else 2048,
                   **(dict(max_local_groups=64) if sat == "grow" else {}))
    h = plan.stream(Src(keys, vals))
    got = tmaps(h.result())
    assert got == oracle_maps(keys, vals)
    assert h.peak_buffered_chunks == 0
    if sat == "grow":
        assert h.executor.bound_grows >= 1 and h.executor._max_groups > 1024
    if (merge, sat) in JAX_PLAN_CASES:
        want = jax_ref.result()[f"{merge}/{sat}"]
        assert {c: got[c] for c in want} == want


def test_jax_commit_restores_in_the_port(jax_ref):
    jax_ref.result()  # the JAX job saved its commit
    want = oracle_maps(jax_ref.ckeys, jax_ref.cvals)
    for n in (4, 2):  # saved on 4 devices: as saved, and re-bucketed onto 2
        restored = plan_on(cpu_mesh(n), aggs=JAX_PLAN_AGGS).restore(
            jax_ref.jax_commit, Src(jax_ref.ckeys, jax_ref.cvals))
        assert restored.chunks_consumed == 5 and restored.executor._ndev == n
        got = tmaps(restored.result())
        assert got == {c: want[c] for c in got}


def test_port_commit_restores_in_jax(jax_ref):
    """The port saved on 2 members; JAX restores it on 4 devices and
    finishes it with the all_to_all merge, as the port does."""
    path = next(p for p in sorted(os.listdir(jax_ref.port_commit)) if p.startswith("step_"))
    arrays = dict(np.load(os.path.join(jax_ref.port_commit, path, "stream.npz")))
    assert arrays["carry/keys"].dtype == np.uint32 and arrays["carry/kbt"].dtype == np.uint32
    assert arrays["carry/count"].dtype == np.int32 and arrays["carry/ovf"].dtype == np.bool_
    assert arrays["carry/keys"].shape[0] == 2
    want = oracle_maps(jax_ref.ckeys, jax_ref.cvals)
    got = jax_ref.result()["port_commit"]
    assert got == {c: want[c] for c in got}
    port = tmaps(plan_on(cpu_mesh(4), "all_to_all", aggs=JAX_PLAN_AGGS).restore(
        jax_ref.port_commit, Src(jax_ref.ckeys, jax_ref.cvals)).result())
    assert port == got
