"""Serving over a mesh of members in repro_torch (``parallel/sharding.py``
``cache_specs``, ``serve/engine.py`` ``serve_cache_shardings``,
``jit_serve_step`` and ``ServeLoop`` on more than one member) against the
JAX package's, on the CPU.

The port runs in this process on virtual CPU members
(``virtual_devices(n, "cpu")``).  The reference's loop over (2, 2), (4, 1)
and (1, 4) meshes needs four devices, so it runs in ONE warm subprocess
with ``--xla_force_host_platform_device_count=4`` (the pattern of
tests/test_torch_sharded.py), on meshes with Auto axes (ROADMAP §3 fault
5: the reference's cache append refuses Explicit axes), sent before the
module's first test.  The cache specs need no devices: the reference's are
taken on ``jax.sharding.AbstractMesh``\\ es in this process.

Models are reduced configs in float32 with the reference's parameters
(``init_params(PRNGKey(0))`` carried across with ``params_from_numpy``);
prompts are made with numpy from seeds.  Greedy tokens must be equal,
token for token; one-step logits are held at rtol 1e-5 of their max |·|."""
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
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.parallel import sharding as jsharding
from repro.serve import engine as jengine
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.parallel import sharding
from repro_torch.serve import engine as tengine

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ARCHS = ["qwen3_0_6b", "granite_moe_1b_a400m", "zamba2_1_2b", "rwkv6_1_6b"]
MESHES = [(2, 2), (4, 1), (1, 4)]
BATCHES = [([3, 7, 1, 5], [6, 4, 9, 2], 1), ([4, 2, 6], [5, 5, 3], 2)]  # lengths, budgets, seed
SLOTS, MAX_LEN = 4, 32
SEQ_STEPS = 3  # one-token jit_serve_step(seq_shard=True) calls at batch 1

# ---------------------------------------------------------------------------
# the warm JAX worker (the pattern of tests/test_torch_sharded.py)

_WORKER_LOOP = r"""
import contextlib, io, json, sys, traceback
for line in sys.stdin:
    req = json.loads(line)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(req["code"], "<serve-test>", "exec"), {"__name__": "__worker__"})
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
        self._err = tempfile.NamedTemporaryFile(mode="w+", prefix="serveworker-",
                                                suffix=".log", delete=False)
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


def prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lengths]


def seq_tokens(cfg):
    return np.random.default_rng(9).integers(0, cfg.vocab_size, (1, SEQ_STEPS)).astype(np.int32)


_JAX_JOB = r"""
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.models import transformer as jtf
from repro.serve import engine
A = %(args)r
IN = dict(np.load(A["inputs"]))
res, OUT = {}, {}
def mesh_of(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))
for arch in A["archs"]:
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    for shape in A["meshes"]:
        key = f"{arch}/{shape[0]}x{shape[1]}"
        try:
            loop = engine.ServeLoop(mesh_of(shape), cfg, params, slots=A["slots"],
                                    max_len=A["max_len"])
            got = []
            for b, (lengths, budgets, seed) in enumerate(A["batches"]):
                reqs = [engine.Request(uid=i, prompt=jnp.asarray(IN[f"{arch}/{b}/{i}"]),
                                       max_new=m) for i, m in enumerate(budgets)]
                got.append([r.generated for r in loop.run_batch(reqs)])
            res[key] = got
        except ValueError as e:
            res[key] = {"error": type(e).__name__}
    mesh = mesh_of((2, 2))
    caches = jtf.init_caches(cfg, 1, A["max_len"], jnp.float32)
    key = f"{arch}/seq"
    try:
        step = engine.jit_serve_step(mesh, cfg, params, caches, seq_shard=True)
        toks = jnp.asarray(IN[f"{arch}/seq"])
        nxt = []
        for j in range(toks.shape[1]):
            t, logits, caches = step(params, toks[:, j:j + 1], caches)
            OUT[f"{key}/{j}"] = np.asarray(logits)
            nxt.append(np.asarray(t).tolist())
        res[key] = nxt
    except ValueError as e:
        res[key] = {"error": type(e).__name__}
np.savez(A["out"], **OUT)
print(json.dumps(res))
"""


_REF_PARAMS: dict = {}


def both(arch):
    """Reduced float32 configs of ``arch`` in both packages, the reference's
    ``init_params(PRNGKey(0))`` (numpy, drawn once a process) and fresh
    port tensors of it."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = jax.tree.map(np.asarray,
                                         jtf.init_params(jax.random.PRNGKey(0), jcfg))
    jp = _REF_PARAMS[arch]
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg)), jp, ttf.params_from_numpy(jp, "cpu")


class JaxReference:
    def __init__(self, d):
        inputs, self._out = str(d / "in.npz"), str(d / "out.npz")
        arrays = {}
        for arch in ARCHS:
            cfg = jconfigs.get_config(arch, reduced=True)
            for b, (lengths, _, seed) in enumerate(BATCHES):
                for i, p in enumerate(prompts(cfg, lengths, seed)):
                    arrays[f"{arch}/{b}/{i}"] = p
            arrays[f"{arch}/seq"] = seq_tokens(cfg)
        np.savez(inputs, **arrays)
        args = {"inputs": inputs, "out": self._out, "archs": ARCHS, "meshes": MESHES,
                "batches": BATCHES, "slots": SLOTS, "max_len": MAX_LEN}
        self._job = JaxJob(_JAX_JOB % {"args": args})
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            self._res = self._job.result()
            self._res["arrays"] = dict(np.load(self._out))
        return self._res


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    return JaxReference(tmp_path_factory.mktemp("serve"))


@pytest.fixture(autouse=True)
def _clean_mesh_state():
    yield
    sharding.reset_virtual_devices()


def cpu_mesh(shape):
    with sharding.virtual_devices(int(np.prod(shape)), "cpu") as members:
        return sharding.make_mesh(shape, ("data", "model"), devices=members)


def flat(tree, specs=None):
    """path → leaf of ``tree``, or → the entry of ``specs`` (a tree shaped
    as ``tree`` whose leaves are spec tuples) at that leaf."""
    out = {}
    if specs is None:
        sharding._map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    else:
        sharding._map_with_path(lambda path, leaf, s: out.__setitem__(path, s), tree, specs)
    return out


def jax_flat(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.__setitem__(jsharding._path_str(path), leaf), tree,
        is_leaf=lambda x: isinstance(x, (P, jax.sharding.NamedSharding)))
    return out


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


# ---------------------------------------------------------------------------
# the port's own checks, first: they run while the JAX worker computes


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_and_shardings_equal_the_reference(arch):
    """Every arch's decode caches (batch 4, 32 positions), spec for spec
    as tuples: ``cache_specs`` on (1, 1), (2, 2), (1, 4) and (4, 1), and
    ``serve_cache_shardings`` with and without ``seq_shard``."""
    jcfg = jconfigs.get_config(arch, reduced=True)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    jc = jax.eval_shape(lambda: jtf.init_caches(jcfg, 4, MAX_LEN, jax.numpy.float32))
    tc = ttf.init_caches(tcfg, 4, MAX_LEN, torch.float32, device="cpu")
    for shape in [(1, 1), (2, 2), (1, 4), (4, 1)]:
        amesh, tmesh = AbstractMesh(shape, ("data", "model")), cpu_mesh(shape)
        want = {k: tuple(v) for k, v in jax_flat(jsharding.cache_specs(amesh, jcfg, jc)).items()}
        assert flat(tc, sharding.cache_specs(tmesh, tcfg, tc)) == want, shape
        for seq in (False, True):
            jsh = jax_flat(jengine.serve_cache_shardings(amesh, jcfg, jc, seq_shard=seq))
            tsh = flat(tc, tengine.serve_cache_shardings(tmesh, tcfg, tc, seq_shard=seq))
            assert {k: v.spec for k, v in tsh.items()} == {k: tuple(v.spec)
                                                           for k, v in jsh.items()}, (shape, seq)
            assert all(v.mesh is tmesh for v in tsh.values())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jit_serve_step_writes_the_parts_in_place(shape):
    """Prefill and decode steps over members: the placed caches stay the
    same tensors, and each step's caches gathered whole equal the
    one-member step's at 1e-5 of their max |·| (the appended k/v
    positions, ``length`` and the states written back; a member's rows
    are a smaller batch, which float32 products may sum in another order),
    next tokens equal and logits at 1e-5."""
    for arch in ("qwen3_0_6b", "zamba2_1_2b"):
        jcfg, tcfg, _, tp = both(arch)
        mesh = cpu_mesh(shape)
        caches = ttf.init_caches(tcfg, 4, MAX_LEN, torch.float32, device="cpu")
        step = tengine.jit_serve_step(mesh, tcfg, tp, caches)
        one = tengine.make_serve_step(tcfg)
        one_caches = ttf.init_caches(tcfg, 4, MAX_LEN, torch.float32, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, jcfg.vocab_size, (4, 7)).astype(np.int32))
        ptrs = None
        for a, b in ((0, 5), (5, 6), (6, 7)):
            nxt, logits, caches = step(tp, toks[:, a:b], caches)
            o_nxt, o_logits, one_caches = one(tp, toks[:, a:b], one_caches)
            assert torch.equal(nxt, o_nxt) and rel(logits, o_logits) <= RTOL
            got, want = flat(caches), flat(one_caches)
            for k in want:
                assert rel(got[k].full("cpu"), want[k]) <= RTOL, (arch, k)
            now = {k: {i: t.data_ptr() for i, t in v.copies.items()} for k, v in got.items()}
            assert ptrs is None or now == ptrs
            ptrs = now


def test_members_on_one_device_share_the_replicated_parts():
    """(2, 2) members of one device: the k/v heads split four ways (four
    parts, four tensors), ``length`` replicated (one tensor that every
    member reads), and the held elements the cache's element count."""
    _, tcfg, _, tp = both("qwen3_0_6b")
    loop = tengine.ServeLoop(cpu_mesh((2, 2)), tcfg, tp, slots=SLOTS, max_len=MAX_LEN)
    c = loop.caches
    assert c.k.sharding.spec == (None, "data", None, "model", None)
    assert len(c.k.copies) == 4 and len(c.length.copies) == 1
    assert c.length.shard((0, 0)).data_ptr() == c.length.shard((1, 1)).data_ptr()
    held = sum(t.numel() for leaf in flat(c).values() for t in leaf.copies.values())
    assert held == sum(leaf.shape.numel() for leaf in flat(c).values())


def test_serve_step_rows_must_split_over_the_data_members():
    _, tcfg, _, tp = both("qwen3_0_6b")
    caches = ttf.init_caches(tcfg, 4, MAX_LEN, torch.float32, device="cpu")
    step = tengine.jit_serve_step(cpu_mesh((4, 1)), tcfg, tp, caches)
    with pytest.raises(ValueError, match="3 token rows do not split over 4"):
        step(tp, torch.zeros((3, 1), dtype=torch.int32), caches)


# ---------------------------------------------------------------------------
# against the reference's results (these wait for the worker)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_loop_over_members_gives_the_reference_tokens(jax_ref, arch, shape):
    """Two batches (ragged prompts and budgets, an empty slot in the
    second) through the port's loop on the mesh's members, token for token
    against the reference's loop on the same mesh.  Where the reference's
    placement refuses the mesh (rwkv6 on (1, 4): ``layers/time/u``), the
    port raises ``ValueError`` too."""
    jcfg, tcfg, _, tp = both(arch)
    want = jax_ref.result()[f"{arch}/{shape[0]}x{shape[1]}"]
    if isinstance(want, dict):
        assert want == {"error": "ValueError"}
        with pytest.raises(ValueError, match="does not"):
            loop = tengine.ServeLoop(cpu_mesh(shape), tcfg, tp, slots=SLOTS, max_len=MAX_LEN)
            loop.run_batch([tengine.Request(uid=0, prompt=[1], max_new=1)])
        return
    loop = tengine.ServeLoop(cpu_mesh(shape), tcfg, tp, slots=SLOTS, max_len=MAX_LEN)
    parts = {k: dict(leaf.copies) for k, leaf in flat(loop.caches).items()}
    for (lengths, budgets, seed), w in zip(BATCHES, want):
        reqs = [tengine.Request(uid=i, prompt=p, max_new=m)
                for i, (p, m) in enumerate(zip(prompts(jcfg, lengths, seed), budgets))]
        assert [r.generated for r in loop.run_batch(reqs)] == w
        assert all(r.done for r in reqs)
    # the held cache: one tensor a (device, part), the same tensors throughout
    for k, leaf in flat(loop.caches).items():
        assert isinstance(leaf, sharding.PlacedTensor), k
        assert sum(t.numel() for t in leaf.copies.values()) == leaf.shape.numel(), k
        assert {i: t.data_ptr() for i, t in leaf.copies.items()} == \
            {i: t.data_ptr() for i, t in parts[k].items()}, k


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_shard_step_matches_the_reference_or_refuses(jax_ref, arch):
    """``jit_serve_step(seq_shard=True)`` at batch 1 on (2, 2): the
    sequence of k/v over both axes, the tokens whole.  qwen3 and granite
    step as the reference (logits at rtol 1e-5, the same next tokens) and
    as the one-member step; zamba2 (``super_ssm/conv``) and rwkv6
    (``state``) raise ``ValueError``, as the reference's placement does."""
    jcfg, tcfg, _, tp = both(arch)
    res = jax_ref.result()
    want = res[f"{arch}/seq"]
    mesh = cpu_mesh((2, 2))
    caches = ttf.init_caches(tcfg, 1, MAX_LEN, torch.float32, device="cpu")
    if isinstance(want, dict):
        assert want == {"error": "ValueError"}
        with pytest.raises(ValueError, match="does not"):
            tengine.jit_serve_step(mesh, tcfg, tp, caches, seq_shard=True)
        return
    step = tengine.jit_serve_step(mesh, tcfg, tp, caches, seq_shard=True)
    one = tengine.make_serve_step(tcfg)
    one_caches = ttf.init_caches(tcfg, 1, MAX_LEN, torch.float32, device="cpu")
    toks = torch.from_numpy(seq_tokens(jcfg))
    for j in range(SEQ_STEPS):
        nxt, logits, caches = step(tp, toks[:, j:j + 1], caches)
        assert rel(logits, res["arrays"][f"{arch}/seq/{j}"]) <= RTOL, j
        assert nxt.tolist() == want[j]
        o_nxt, o_logits, one_caches = one(tp, toks[:, j:j + 1], one_caches)
        assert rel(logits, o_logits) <= RTOL and torch.equal(nxt, o_nxt)
    for k, leaf in flat(caches).items():
        assert rel(leaf.full("cpu"), flat(one_caches)[k]) <= RTOL, k
    assert caches.k.sharding.spec == (None, None, ("data", "model"), None, None)
