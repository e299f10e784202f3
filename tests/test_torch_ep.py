"""Expert parallelism of repro_torch (``models/moe.py`` ``moe_mlp_ep``,
``models/transformer.py`` ``_moe_ep_shardmapped``, ``moe_impl="ep"``
through ``forward``, ``decode_step`` and ``make_train_step``) against the
JAX package's, on the CPU.

The port runs in this process on single-controller meshes of virtual CPU
members (``virtual_devices(n, "cpu")``).  The reference's expert
parallelism is ``shard_map`` with ``jax.lax.all_to_all`` over real
devices, so it runs in ONE warm subprocess with
``--xla_force_host_platform_device_count=4`` (the pattern of
tests/test_torch_sharded.py), on meshes with Auto axes inside
``jax.set_mesh`` (ROADMAP §3 fault 5: Explicit axes fail in its scan).
The request is sent before the module's first test; the port's own tests
run while JAX computes.  On jax 0.9 a jitted reference step reused after a
jitted ticketed MoE gradient fails ("supplied N buffers but compiled
program expected N+3"), so the worker runs its training steps first and
jits every reference call afresh.

Model: reduced granite-moe-1b-a400m in float32 (8 experts padded to 16,
top-2, d 128, 2 layers), the reference's ``init_params(PRNGKey(0))``
carried across with ``params_from_numpy``; tokens from numpy seeds.
Tolerances: outputs, logits, losses, aux and gradients at rtol 1e-5 (of
each array's max |·|); training steps as ``tests/test_torch_dp.py`` holds
them (loss and grad_norm rtol 1e-5, parameters within the summed lr and a
median 1e-3 of it).  Under ``quantize_dispatch`` a bucket value within
float32 rounding of an int8 code boundary may take the neighbouring code
in one package and not the other (the two compute the model's float32
activations in different orders): where the port's buckets in a model-level
call hold a value within 1e-4 of a code's boundary, that call's logits are
held to 1e-3 (one code step of one row, max|bucket|/127), else to 1e-5.
The capacity of the training case follows the
reference's rule for its ``moe_ts2`` cell (``launch/dryrun.py:55-80``
``_ep_info``: t_local·k·1.0/E_pad tokens after the token slice, rounded up
to 8, at least 8), which drops rows here."""
import atexit
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import ShapeCell as TShapeCell
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding
from repro_torch.train import loop as tloop

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
B, S = 4, 16

# ---------------------------------------------------------------------------
# the warm JAX worker (the pattern of tests/test_torch_sharded.py)

_WORKER_LOOP = r"""
import contextlib, io, json, sys, traceback
for line in sys.stdin:
    req = json.loads(line)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(req["code"], "<ep-test>", "exec"), {"__name__": "__worker__"})
        out = buf.getvalue().strip().splitlines()
        payload = {"out": out[-1] if out else ""}
    except BaseException:
        payload = {"err": traceback.format_exc()[-3000:], "out": buf.getvalue()[-2000:]}
    sys.stdout.write(json.dumps(payload) + "\n")
    sys.stdout.flush()
"""

_PROCS: list = []


@atexit.register
def _shutdown_workers():
    for proc in _PROCS:
        if proc.poll() is None:
            proc.kill()


class JaxJob:
    """One request to a fresh 4-device worker, sent when made and read when
    first needed."""

    def __init__(self, code: str):
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.path.join(REPO, "src"))
        self._err = tempfile.NamedTemporaryFile(mode="w+", prefix="epworker-", suffix=".log",
                                                delete=False)
        self._proc = subprocess.Popen([sys.executable, "-c", _WORKER_LOOP],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      stderr=self._err, text=True, env=env)
        _PROCS.append(self._proc)
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
            self._err.seek(0)
            pytest.fail(f"the 4-device worker hung or died; stderr:\n{self._err.read()[-3000:]}")
        payload = json.loads(self._reply["line"])
        assert "err" not in payload, payload.get("err")
        self._proc.stdin.close()
        return json.loads(payload["out"])


# mesh cases: (shape, axes, token_slice, quantize_dispatch, capacity)
FORWARD_CASES = [
    ((1, 4), ("data", "model"), False, False, 64),
    ((1, 4), ("data", "model"), True, False, 64),
    ((2, 2), ("data", "model"), False, False, 64),
    ((2, 2), ("data", "model"), True, False, 64),
    ((2, 2), ("data", "model"), False, True, 64),
    ((2, 2), ("data", "model"), True, True, 8),
    ((2, 2), ("data", "model"), False, False, 8),
    ((2, 1, 2), ("pod", "data", "model"), False, False, 64),
    ((2, 1, 2), ("pod", "data", "model"), True, True, 64),
]
DECODE_CASES = [  # decode batch 2: with the token slice over 4 members, two zero rows pad it
    ((1, 4), ("data", "model"), False, False, 64),
    ((1, 4), ("data", "model"), True, False, 64),
    ((2, 2), ("data", "model"), True, True, 8),
    ((2, 1, 2), ("pod", "data", "model"), True, False, 64),
]
MOE_CASES = [(64, False), (8, False), (64, True), (8, True)]  # (capacity, quantize)
TRAIN_MESH = ((2, 2), ("data", "model"))
TRAIN_STEPS = 3
TRAIN_HP = dict(peak_lr=1e-3, warmup=0, total_steps=10)


def moe_ts2_capacity(cfg, b, s, mesh_shape, axes):
    """The dry run's ``_ep_info`` capacity for a ``moe_ts2`` training cell
    of ``b`` × ``s`` tokens on a mesh of ``mesh_shape`` (the reference's
    rule, ``launch/dryrun.py``)."""
    n = int(np.prod(mesh_shape))
    members = [sharding.MeshDevice(i, torch.device("meta")) for i in range(n)]
    mesh = sharding.make_mesh(mesh_shape, axes, devices=members)
    info, _ = tdryrun._ep_info(mesh, cfg, TShapeCell("ep_train", s, b, "train"), "moe_ts2")
    return info["capacity_per_expert"]


def jcfg_tcfg():
    jcfg = dataclasses.replace(jconfigs.get_config("granite_moe_1b_a400m", reduced=True),
                               dtype="float32")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def tokens_np(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


def moe_inputs(cfg):
    rng = np.random.default_rng(7)
    x = (0.1 * rng.normal(size=(8, S, cfg.d_model))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, g


_JAX_JOB = r"""
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro import configs
from repro.models import moe as moe_lib, transformer as jtf
from repro.optim import adamw
from repro.parallel.sharding import dp_axes, shard_map
from repro.train import loop as jloop
A = %(args)r
OUT = {}
cfg = dataclasses.replace(configs.get_config("granite_moe_1b_a400m", reduced=True), dtype="float32")
params = jtf.init_params(jax.random.PRNGKey(0), cfg)
IN = dict(np.load(A["inputs"]))
def mesh_of(shape, axes):
    return jax.make_mesh(tuple(shape), tuple(axes), axis_types=(AxisType.Auto,) * len(shape))
def info_of(mesh, ts, q, cap):
    return dict(mesh=mesh, dp=dp_axes(mesh), capacity_per_expert=cap, token_slice=ts,
                quantize_dispatch=q)
def np_tree(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(np_tree(v, prefix + "/" + k))
        return out
    return {prefix: np.asarray(t)}
res = {"params_sum": float(sum(np.abs(np.asarray(x, np.float64)).sum()
                               for x in jax.tree.leaves(params)))}
toks = IN["train_tokens"]
batch = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
# 1. training steps first (fault 5), each jitted afresh
mesh = mesh_of(*A["train_mesh"])
hp = jloop.TrainHParams(**A["train_hp"])
info = info_of(mesh, True, True, A["train_cap"])
with jax.set_mesh(mesh):
    base = jloop.make_train_step(cfg, hp, moe_impl="ep", ep_info=info)
    p, opt, metrics = params, adamw.init(params), []
    for i in range(A["train_steps"]):
        p, opt, m = jax.jit(lambda *a: base(*a))(p, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        for k, v in np_tree(p).items():
            OUT[f"train{i}" + k] = v
res["train"] = metrics
# 2. moe_mlp_ep over 4 model members, each member its own tokens
mesh = mesh_of((4,), ("model",))
p_moe = moe_lib.moe_init(jax.random.PRNGKey(0), cfg)
x, g = jnp.asarray(IN["moe_x"]), jnp.asarray(IN["moe_g"])
for cap, q in A["moe_cases"]:
    def run(x, pg, pu, pd, router, cap=cap, q=q):
        out, aux = moe_lib.moe_mlp_ep({"router": router, "w_gate": pg, "w_up": pu, "w_down": pd},
                                      cfg, x, axis="model", num_shards=4,
                                      capacity_per_expert=cap, quantize_dispatch=q)
        return out, aux[None]
    fn = shard_map(run, mesh=mesh, in_specs=(P("model"), P("model"), P("model"), P("model"), P()),
                   out_specs=(P("model"), P("model")), check_vma=False)
    def loss(x, pg, pu, pd, router):
        out, aux = fn(x, pg, pu, pd, router)
        return jnp.sum(out * g) + jnp.sum(aux), (out, aux)
    with jax.set_mesh(mesh):
        args = (x, p_moe["w_gate"], p_moe["w_up"], p_moe["w_down"], p_moe["router"])
        (_, (out, aux)), grads = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    tag = f"moe_{cap}_{int(q)}"
    OUT[tag + "/out"], OUT[tag + "/aux"] = np.asarray(out), np.asarray(aux)
    for name, gr in zip(("x", "w_gate", "w_up", "w_down", "router"), grads):
        for k, v in np_tree(gr).items():
            OUT[tag + "/grad/" + name + k] = v
# 3. forward and lm_loss
ftoks = IN["fwd_tokens"]
fb = {"tokens": jnp.asarray(ftoks[:, :-1]), "targets": jnp.asarray(ftoks[:, 1:])}
for i, (shape, axes, ts, q, cap) in enumerate(A["forward_cases"]):
    mesh = mesh_of(shape, axes)
    info = info_of(mesh, ts, q, cap)
    def fl(p, b, info=info):
        out = jtf.forward(p, cfg, b, ticketed_embedding=False, moe_impl="ep", ep_info=info)
        loss, m = jtf.lm_loss(p, cfg, b, ticketed_embedding=False, moe_impl="ep", ep_info=info)
        return out.logits, out.aux_loss, loss
    with jax.set_mesh(mesh):
        logits, aux, loss = jax.jit(fl)(params, fb)
    OUT[f"fwd{i}/logits"], OUT[f"fwd{i}/aux"], OUT[f"fwd{i}/loss"] = map(np.asarray, (logits, aux, loss))
# 4. cached prefill, then two decode steps
dtoks = jnp.asarray(IN["dec_tokens"])
for i, (shape, axes, ts, q, cap) in enumerate(A["decode_cases"]):
    mesh = mesh_of(shape, axes)
    info = info_of(mesh, ts, q, cap)
    def dstep(p, t, c, info=info):
        return jtf.decode_step(p, cfg, t, c, moe_impl="ep", ep_info=info)
    with jax.set_mesh(mesh):
        caches = jtf.init_caches(cfg, dtoks.shape[0], 16, jnp.float32)
        for j, (a, b) in enumerate(((0, 5), (5, 6), (6, 7))):
            logits, caches = jax.jit(dstep)(params, dtoks[:, a:b], caches)
            OUT[f"dec{i}/{j}"] = np.asarray(logits)
np.savez(A["out"], **OUT)
print(json.dumps(res))
"""


class JaxReference:
    def __init__(self, d):
        jcfg, _ = jcfg_tcfg()
        self.train_tokens = tokens_np(jcfg, B, S, 0)
        self.fwd_tokens = tokens_np(jcfg, B, S, 1)
        self.dec_tokens = tokens_np(jcfg, 2, 6, 2)
        self.moe_x, self.moe_g = moe_inputs(jcfg)
        inputs, self._out = str(d / "in.npz"), str(d / "out.npz")
        np.savez(inputs, train_tokens=self.train_tokens, fwd_tokens=self.fwd_tokens,
                 dec_tokens=self.dec_tokens, moe_x=self.moe_x, moe_g=self.moe_g)
        self.train_cap = moe_ts2_capacity(TModelConfig(**dataclasses.asdict(jcfg)), B, S,
                                          *TRAIN_MESH)
        args = {"inputs": inputs, "out": self._out, "train_mesh": TRAIN_MESH,
                "train_hp": TRAIN_HP, "train_cap": self.train_cap, "train_steps": TRAIN_STEPS,
                "moe_cases": MOE_CASES, "forward_cases": FORWARD_CASES,
                "decode_cases": DECODE_CASES}
        self._job = JaxJob(_JAX_JOB % {"args": args})
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            self._res = self._job.result()
            self._res["arrays"] = dict(np.load(self._out))
        return self._res


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    return JaxReference(tmp_path_factory.mktemp("ep"))


@pytest.fixture(autouse=True)
def _clean_mesh_state():
    yield
    sharding.reset_virtual_devices()


# ---------------------------------------------------------------------------
# helpers


_REF_PARAMS: dict = {}


def ref_params(jcfg):
    """The reference's ``init_params(PRNGKey(0))`` (numpy, drawn once a
    process) and fresh port tensors of it."""
    if jcfg.name not in _REF_PARAMS:
        _REF_PARAMS[jcfg.name] = jax.tree.map(
            np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    jp = _REF_PARAMS[jcfg.name]
    return jp, ttf.params_from_numpy(jp, "cpu")


def cpu_mesh(shape, axes):
    with sharding.virtual_devices(int(np.prod(shape)), "cpu") as members:
        return sharding.make_mesh(shape, axes, devices=members)


def ep_info(mesh, token_slice, quantize, cap):
    return dict(mesh=mesh, dp=sharding.dp_axes(mesh), capacity_per_expert=cap,
                token_slice=token_slice, quantize_dispatch=quantize)


def batch_of(toks):
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "targets": torch.from_numpy(toks[:, 1:].copy())}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy()}


def local_params(p_moe, n):
    e_local = p_moe["w_gate"].shape[0] // n
    return [ttf._local_moe(p_moe, r, e_local, torch.device("cpu")) for r in range(n)]


def cpu_members(n):
    return [sharding.MeshDevice(i, torch.device("cpu")) for i in range(n)]


class BoundaryGap:
    """Records, over the port's int8 exchanges inside it, the least
    distance of a quantized value ``f / scale`` to a rounding boundary."""

    def __enter__(self):
        self._orig, self.gap = tmoe._exchange, float("inf")

        def spy(buckets, members, quantize):
            if quantize:
                for b in buckets:
                    f = b.detach().float()
                    r = f / (torch.amax(f.abs(), dim=(1, 2), keepdim=True) / 127.0 + 1e-8)
                    self.gap = min(self.gap, float((r - r.floor() - 0.5).abs().min()))
            return self._orig(buckets, members, quantize)

        tmoe._exchange = spy
        return self

    def __exit__(self, *exc):
        tmoe._exchange = self._orig

    def tolerance(self) -> float:
        return RTOL if self.gap > 1e-4 else 1e-3


def case_id(case):
    shape, _, ts, q, cap = case
    return f"{'x'.join(map(str, shape))}-ts{int(ts)}-q{int(q)}-cap{cap}"


# ---------------------------------------------------------------------------
# the port's own checks, first: they run while the JAX worker computes


def test_moe_mlp_ep_with_ample_capacity_equals_the_dense_layer():
    """Capacity 64 drops nothing: each member's output is
    ``moe_mlp_dense`` of its tokens, and its aux loss that layer's."""
    jcfg, tcfg = jcfg_tcfg()
    p_moe = ttf.params_from_numpy(
        jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg)), "cpu")
    x, _ = moe_inputs(jcfg)
    xs = list(torch.from_numpy(x).split(2))
    res = tmoe.moe_mlp_ep(local_params(p_moe, 4), tcfg, xs, members=cpu_members(4),
                          capacity_per_expert=64)
    for (out, aux), xm in zip(res, xs):
        d_out, d_aux = tmoe.moe_mlp_dense(p_moe, tcfg, xm)
        assert rel(out, d_out) <= RTOL
        np.testing.assert_allclose(float(aux), float(d_aux), rtol=RTOL)


def test_moe_mlp_ep_checks_its_members():
    jcfg, tcfg = jcfg_tcfg()
    p_moe = ttf.params_from_numpy(
        jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg)), "cpu")
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="do not split over 3"):
        tmoe.moe_mlp_ep([p_moe] * 3, tcfg, [x] * 3, members=cpu_members(3), capacity_per_expert=8)
    with pytest.raises(ValueError, match="for 4 members"):
        tmoe.moe_mlp_ep(local_params(p_moe, 4), tcfg, [x] * 3, members=cpu_members(4),
                        capacity_per_expert=8)


def test_route_orders_tied_experts_as_jax_top_k():
    """A zero row (the token slice's padding) ties every expert: the port
    picks the lowest ids first, as ``jax.lax.top_k``."""
    jcfg, tcfg = jcfg_tcfg()
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = np.zeros((3, jcfg.d_model), np.float32)
    x[1] = 0.1
    want = jmoe.route(jp, jcfg, jax.numpy.asarray(x))
    got = tmoe.route(ttf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), tcfg,
                     torch.from_numpy(x))
    np.testing.assert_array_equal(got.experts.numpy(), np.asarray(want.experts))
    np.testing.assert_array_equal(got.histogram.numpy(), np.asarray(want.histogram))


def test_ep_with_ample_capacity_matches_the_dense_forward_on_every_mesh():
    """Capacity 64 drops nothing, so the logits are the dense path's; the
    aux loss is the dense one where one data member routes the whole batch
    without the token slice, and the reference's mean of means otherwise."""
    jcfg, tcfg = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    batch = batch_of(tokens_np(jcfg, B, S, 3))
    dense = ttf.forward(tp, tcfg, batch, ticketed_embedding=False)
    for shape, axes, ts, q, cap in FORWARD_CASES:
        if cap != 64 or q:
            continue
        info = ep_info(cpu_mesh(shape, axes), ts, False, cap)
        out = ttf.forward(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)
        assert rel(out.logits, dense.logits) <= RTOL, (shape, ts)
        if shape == (1, 4) and not ts:
            np.testing.assert_allclose(float(out.aux_loss), float(dense.aux_loss), rtol=RTOL)


def test_ep_train_step_with_ample_capacity_equals_the_dense_step():
    """On (data 1, model 4) without the token slice one data member routes
    the whole batch, so with no drops the EP step is the dense step: three
    steps, metrics at rtol 1e-5 and parameters within the dp tolerance."""
    jcfg, tcfg = jcfg_tcfg()
    _, p_ep = ref_params(jcfg)
    _, p_dense = ref_params(jcfg)
    hp = tloop.TrainHParams(**TRAIN_HP)
    info = ep_info(cpu_mesh((1, 4), ("data", "model")), False, False, 64)
    ep = tloop.make_train_step(tcfg, hp, moe_impl="ep", ep_info=info)
    dense = tloop.make_train_step(tcfg, hp)
    o_ep, o_dense = tadamw.init(p_ep), tadamw.init(p_dense)
    lr_sum = 0.0
    for i in range(TRAIN_STEPS):
        batch = batch_of(tokens_np(jcfg, B, S, 10 + i))
        p_ep, o_ep, m_ep = ep(p_ep, o_ep, batch)
        p_dense, o_dense, m_dense = dense(p_dense, o_dense, batch)
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m_ep[k]), float(m_dense[k]), rtol=RTOL, err_msg=k)
        lr_sum += float(m_dense["lr"])
    fe, fd = flat(p_ep), flat(p_dense)
    diffs = np.concatenate([np.abs(fe[k] - fd[k]).ravel() for k in fd])
    assert diffs.max() <= lr_sum and np.median(diffs) <= 1e-3 * lr_sum


def test_ep_refuses_what_does_not_split():
    jcfg, tcfg = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    batch = batch_of(tokens_np(jcfg, B, S, 4))
    info = ep_info(cpu_mesh((1, 3), ("data", "model")), False, False, 64)
    with pytest.raises(ValueError, match="do not split over a model axis of 3"):
        ttf.forward(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)
    info = ep_info(cpu_mesh((3, 2), ("data", "model")), False, False, 64)
    with pytest.raises(ValueError, match="4 rows do not split over 3"):
        ttf.forward(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)
    info = ep_info(cpu_mesh((4,), ("model",)), False, False, 64)
    with pytest.raises(ValueError, match="lacks"):
        ttf.forward(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)


def test_members_read_the_expert_stacks_as_views():
    """Member r's experts are rows [r·E_local, (r+1)·E_local) of the
    layer's stacks, in the stack's own storage where it shares the
    device: nothing is copied per member."""
    jcfg, _ = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    layer = ttf._unstack(tp["layers"])[1]["moe"]
    for r, p in enumerate(local_params(layer, 4)):
        for w in ("w_gate", "w_up", "w_down"):
            stack = layer[w]
            assert p[w].untyped_storage().data_ptr() == stack.untyped_storage().data_ptr()
            assert p[w].data_ptr() == stack[4 * r].data_ptr()
            assert torch.equal(p[w], stack[4 * r:4 * (r + 1)])


# ---------------------------------------------------------------------------
# against the reference's results (these wait for the worker)


@pytest.mark.parametrize("cap,quantize", MOE_CASES)
def test_moe_mlp_ep_matches_the_reference_per_member(jax_ref, cap, quantize):
    """The tests/test_distributed.py:180-208 recipe, each of 4 model
    members with its own 2 × 16 tokens: every member's output and aux
    loss, and the gradients of Σ out·g + Σ aux with respect to the tokens,
    the three expert stacks and the router (through the int8 exchange's
    scale under ``quantize_dispatch``)."""
    jcfg, tcfg = jcfg_tcfg()
    p_moe = ttf.params_from_numpy(
        jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg)), "cpu")
    p_moe = ttf.tree_map(lambda t: t.requires_grad_(True), p_moe)
    x_np, g_np = jax_ref.moe_x, jax_ref.moe_g
    x = torch.from_numpy(x_np.copy()).requires_grad_(True)
    res = tmoe.moe_mlp_ep(local_params(p_moe, 4), tcfg, list(x.split(2)), members=cpu_members(4),
                          capacity_per_expert=cap, quantize_dispatch=quantize)
    out = torch.cat([o for o, _ in res])
    aux = torch.stack([a for _, a in res])
    loss = (out * torch.from_numpy(g_np)).sum() + aux.sum()
    leaves = [x, p_moe["w_gate"], p_moe["w_up"], p_moe["w_down"], p_moe["router"]["w"]]
    grads = torch.autograd.grad(loss, leaves)

    ref = jax_ref.result()["arrays"]
    tag = f"moe_{cap}_{int(quantize)}"
    assert rel(out.detach(), ref[tag + "/out"]) <= RTOL
    np.testing.assert_allclose(aux.detach().numpy(), ref[tag + "/aux"], rtol=RTOL)
    for name, gr in zip(("x", "w_gate", "w_up", "w_down", "router/w"), grads):
        assert rel(gr, ref[f"{tag}/grad/{name}"]) <= RTOL, name


@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_ep_forward_and_loss_match_the_reference(jax_ref, case):
    shape, axes, ts, q, cap = case
    jcfg, tcfg = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    info = ep_info(cpu_mesh(shape, axes), ts, q, cap)
    batch = batch_of(jax_ref.fwd_tokens)
    with BoundaryGap() as gap:
        out = ttf.forward(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)
        loss, _ = ttf.lm_loss(tp, tcfg, batch, ticketed_embedding=False, moe_impl="ep",
                              ep_info=info)
    i = FORWARD_CASES.index(case)
    ref = jax_ref.result()["arrays"]
    assert rel(out.logits, ref[f"fwd{i}/logits"]) <= gap.tolerance(), gap.gap
    np.testing.assert_allclose(float(out.aux_loss), float(ref[f"fwd{i}/aux"]), rtol=RTOL)
    np.testing.assert_allclose(float(loss), float(ref[f"fwd{i}/loss"]), rtol=gap.tolerance())


@pytest.mark.parametrize("case", DECODE_CASES, ids=case_id)
def test_ep_decode_step_matches_the_reference(jax_ref, case):
    """A 5-token cached prefill, then two one-token steps, batch 2."""
    shape, axes, ts, q, cap = case
    jcfg, tcfg = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    info = ep_info(cpu_mesh(shape, axes), ts, q, cap)
    toks = torch.from_numpy(jax_ref.dec_tokens.copy())
    caches = ttf.init_caches(tcfg, toks.shape[0], 16, torch.float32, device="cpu")
    i = DECODE_CASES.index(case)
    ref = jax_ref.result()["arrays"]
    tol = RTOL
    for j, (a, b) in enumerate(((0, 5), (5, 6), (6, 7))):
        with BoundaryGap() as gap:  # a flipped code moves the cache of later calls too
            logits, caches = ttf.decode_step(tp, tcfg, toks[:, a:b], caches, moe_impl="ep",
                                             ep_info=info)
        tol = max(tol, gap.tolerance())
        assert rel(logits, ref[f"dec{i}/{j}"]) <= tol, (j, gap.gap)


def test_ep_train_step_matches_the_reference_jitted_step(jax_ref):
    """Three ``make_train_step(moe_impl="ep")`` steps on (data 2, model 2)
    with the token slice, int8 dispatch and the moe_ts2 capacity (ticketed
    embedding), against the reference's jitted EP step."""
    jcfg, tcfg = jcfg_tcfg()
    _, tp = ref_params(jcfg)
    info = ep_info(cpu_mesh(*TRAIN_MESH), True, True, jax_ref.train_cap)
    hp = tloop.TrainHParams(**TRAIN_HP)
    step = tloop.make_train_step(tcfg, hp, moe_impl="ep", ep_info=info)
    batch = batch_of(jax_ref.train_tokens)
    opt = tadamw.init(tp)
    got = []
    for _ in range(TRAIN_STEPS):
        tp, opt, m = step(tp, opt, batch)
        got.append({k: float(v) for k, v in m.items()})
    res = jax_ref.result()
    jp, _ = ref_params(jcfg)
    assert res["params_sum"] == pytest.approx(
        sum(np.abs(np.asarray(x, np.float64)).sum() for x in jax.tree.leaves(jp)), rel=1e-12)
    lr_sum = 0.0
    for i, (g, w) in enumerate(zip(got, res["train"])):
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        lr_sum += w["lr"]
    arrays = res["arrays"]
    fg = flat(tp)
    diffs = np.concatenate([np.abs(fg[k] - arrays[f"train{TRAIN_STEPS - 1}" + k]).ravel()
                            for k in fg])
    assert diffs.max() <= lr_sum and np.median(diffs) <= 1e-3 * lr_sum
