"""LM training on one member in repro_torch (``train/loop.py``,
``train/fault_tolerance.py``, ``data/pipeline.py``'s ``SyntheticLM``, the
ticketed embedding's backward with kernel B5's plain version, the
checkpoint format of optimizer state, B3's autograd node) against the JAX
package's, on the CPU.

Parameters are the reference's, carried across with ``params_from_numpy``;
inputs are made with numpy from a seed.  The model runs in float32 here
(bf16 rounding would hide the algorithm).  Tolerances, stated where used:
the embedding gradient sums the same rows in another order (rtol 1e-6 of
the rows' |g| sum); the loss agrees to rtol 1e-5 and every gradient leaf to
max|Δ| <= 1e-5 · max|g| (float32 matmuls and reductions in another order);
AdamW's normalised update can turn such a difference into up to lr · O(1)
where a gradient entry is near 0, so parameters after three steps are held
to an atol of the summed step sizes (see the test)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train.fault_tolerance import StragglerPolicy as JStragglerPolicy
from repro_torch import train as ttrain
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.core.hashing import table_capacity
from repro_torch.data.pipeline import DataState, SyntheticLM
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import segment_rows as sr
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding
from repro_torch.train import elastic, fault_tolerance, loop as tloop

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

CPU = "cpu"
EMBED_RTOL = 1e-6      # |Δ| <= EMBED_RTOL · Σ|g| over the id's rows
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5       # max|Δ| <= GRAD_RTOL · max|g| per leaf


def cfgs(arch="qwen3_0_6b"):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def ref_params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def flat(tree, prefix=""):
    """path → numpy array of a nested dict (JAX or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def zipf_ids(shape, vocab, seed, a=1.2):
    z = np.random.default_rng(seed).zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def cpu_mesh(n=1):
    with sharding.virtual_devices(n, CPU) as members:
        return sharding.make_mesh((n, 1), ("data", "model"), devices=members)


def jax_mesh():
    # Auto axes, as tests/test_torch_serve_lm.py builds them (ROADMAP fault 5)
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


# -- kernel B5's plain version ---------------------------------------------------

@pytest.mark.parametrize("rows,groups,d,hot", [(300, 64, 16, 0.0), (1024, 1024, 32, 0.18),
                                               (1500, 7, 5, 0.5), (1, 1, 4, 0.0),
                                               (700, 50, 12, 1.0),          # every row on one ticket
                                               (700, 50, 12, "dropped")])   # every ticket dropped
def test_segment_rows_plain_matches_segment_sum(rows, groups, d, hot):
    rng = np.random.default_rng(rows + d)
    t = rng.integers(-1, groups + 3, size=rows).astype(np.int32)   # -1 and >= G dropped
    if hot == "dropped":
        t = np.where(t < groups // 2, -1, groups + t % 3).astype(np.int32)
    else:
        t[rng.random(rows) < hot] = groups // 2                    # a hot ticket
    x = rng.standard_normal((rows, d)).astype(np.float32)
    got = sr.segment_rows(torch.from_numpy(x), torch.from_numpy(t), groups)
    assert got.shape == (groups, d) and got.dtype == torch.float32
    # the reference's form: tickets outside [0, G) go to segment G, dropped
    seg = jnp.where((t >= 0) & (t < groups), t, groups)
    want = jax.ops.segment_sum(jnp.asarray(x), seg, num_segments=groups + 1)[:groups]
    scale = jax.ops.segment_sum(jnp.abs(jnp.asarray(x)), seg, num_segments=groups + 1)[:groups]
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= EMBED_RTOL * np.asarray(scale) + 1e-30)
    assert torch.equal(got, sr.segment_rows_plain(torch.from_numpy(x), torch.from_numpy(t),
                                                  groups))


def test_segment_rows_checks_its_inputs():
    x, t = torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        sr.segment_rows(x.double(), t, 2)
    with pytest.raises(ValueError):
        sr.segment_rows(x, t.long(), 2)
    with pytest.raises(ValueError):
        sr.segment_rows(x, t[:3], 2)
    assert sr.segment_rows(x[:0], t[:0], 5).shape == (5, 3)
    assert sr.segment_rows.launches == 0  # CPU tensors never launch


# -- the ticketed embedding's gradient ----------------------------------------------

EMBED_CASES = {
    # (B, S, vocab, d, max_unique: None = min(vocab, B·S) as forward sizes it)
    "zipf_ragged": (3, 100, 512, 16, None),        # 300 ids, not a multiple of 1024
    "zipf_two_tiles": (5, 300, 4096, 8, None),     # 1500 ids over two 1024-row tiles
    "exact_bound": (2, 64, 512, 8, "distinct"),    # max_unique == the distinct count
}


@pytest.mark.parametrize("case", sorted(EMBED_CASES))
def test_ticketed_embed_grad_matches_reference_and_dense(case):
    b, s, vocab, d, mu = EMBED_CASES[case]
    rng = np.random.default_rng(len(case))
    ids = zipf_ids((b, s), vocab, seed=b * s)
    assert np.mean(ids == 0) > 0.1                         # a heavy hitter
    distinct = len(np.unique(ids))
    max_unique = min(vocab, b * s) if mu is None else distinct
    cap = table_capacity(max_unique)
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    g = rng.standard_normal((b, s, d)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jlayers.ticketed_embed(t, jnp.asarray(ids), max_unique, cap) * g)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = tlayers.ticketed_embed(tt, torch.from_numpy(ids), max_unique, cap)
    (got,) = torch.autograd.grad(out, tt, torch.from_numpy(g))
    tt2 = torch.from_numpy(table).requires_grad_(True)
    dense = tlayers.embed({"table": tt2}, torch.from_numpy(ids), torch.float32)
    (dense_g,) = torch.autograd.grad(dense, tt2, torch.from_numpy(g))
    absum = np.zeros_like(table)
    np.add.at(absum, ids.reshape(-1), np.abs(g.reshape(-1, d)))
    tol = EMBED_RTOL * absum + 1e-30
    assert got.shape == (vocab, d) and got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= tol)
    assert np.all(np.abs(got.numpy() - dense_g.numpy()) <= tol)
    touched = np.zeros(vocab, bool)
    touched[ids.reshape(-1)] = True
    assert not got.numpy()[~touched].any()
    assert torch.equal(got, tlayers.ticketed_embed_grad_plain(
        torch.from_numpy(ids), torch.from_numpy(g), vocab, max_unique, cap))


# -- SyntheticLM ------------------------------------------------------------------
#
# These run before the gradient tests: on jax 0.9, the reference's stats
# executor (its jitted scan) fails with "Execution supplied 8 buffers but
# compiled program expected 9" when it first runs after the jitted
# value_and_grad of the ticketed lm_loss in the same process (seen only
# under pytest; not a fault of the port, whose stream these tests check).

def test_synthetic_lm_tokens_and_stats_equal_reference():
    jcfg, tcfg = cfgs()
    jd = JSyntheticLM(jcfg, batch=4, seq=128, seed=7, track_stats=True, stat_groups=512)
    td = SyntheticLM(tcfg, batch=4, seq=128, seed=7, track_stats=True, stat_groups=512,
                     device=CPU)
    ji, ti = iter(jd), iter(td)
    for _ in range(3):
        jb, tb = next(ji), next(ti)
        assert set(tb) == {"tokens", "targets"}
        assert tb["tokens"].dtype == torch.int32 and tb["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(tb["targets"].numpy(), np.asarray(jb["targets"]))
    assert td.state == DataState(seed=7, step=3) and jd.state.step == 3
    tk_, tc = td.token_stats()
    jk, jc = jd.token_stats()
    assert tk_.dtype == np.uint32 and tc.dtype == np.float32
    assert dict(zip(tk_.tolist(), tc.tolist())) == dict(zip(jk.tolist(), jc.tolist()))
    # Zipf: token 0 is the heaviest tracked hitter
    assert tc.sum() <= 3 * 4 * 128 and tc.max() == tc[list(tk_).index(0)]
    # chunks() advances the same state and yields the tracked key column
    chunk = next(td.chunks())
    assert td.state.step == 4 and chunk.num_rows == 4 * 128


def test_synthetic_lm_stats_total_is_the_tracked_rows():
    _, tcfg = cfgs()
    td = SyntheticLM(tcfg, batch=2, seq=64, seed=1, stat_groups=64, device=CPU)
    it = iter(td)
    tracked = 0
    for _ in range(4):
        b = next(it)
        tracked += int((b["tokens"] < 32).sum())
    keys, counts = td.token_stats()
    assert counts.sum() == tracked and keys.max() < 32
    assert SyntheticLM(tcfg, 1, 4, track_stats=False, device=CPU).token_stats()[0].size == 0


def test_synthetic_lm_frontend_extras_have_the_reference_shapes():
    jcfg, tcfg = cfgs("internvl2_2b")
    td = SyntheticLM(tcfg, batch=2, seq=32, seed=0, track_stats=False, device=CPU)
    jd = JSyntheticLM(jcfg, batch=2, seq=32, seed=0, track_stats=False)
    tb, jb = next(iter(td)), next(iter(jd))
    assert set(tb) == set(jb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
    fe = tb["frontend_embeds"]
    assert fe.dtype == torch.float32 and 0.01 < float(fe.std()) < 0.03


# -- lm_loss and the training step ---------------------------------------------------

def batch_np(jcfg, b, s, seed):
    toks = zipf_ids((b, s + 1), jcfg.vocab_size, seed)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_lm_loss_and_gradients_match_reference_with_ticketed_embedding():
    jcfg, tcfg = cfgs()
    assert jcfg.tie_embeddings  # the tied head adds to the same table gradient
    jp, tp = ref_params(jcfg, seed=1)
    bn = batch_np(jcfg, 2, 24, seed=5)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb, ticketed_embedding=True), has_aux=True))(jp)
    tree = ttf.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tl, tm = ttf.lm_loss(tree, tcfg, {k: torch.from_numpy(v) for k, v in bn.items()},
                         ticketed_embedding=True)
    flat_g = iter(torch.autograd.grad(tl, list(ttf._leaves(tree))))
    tg = ttf.tree_map(lambda _: next(flat_g), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["nll"].detach()), float(jm["nll"]), rtol=LOSS_RTOL)
    fj, ft = flat(jg), flat(tg)
    assert set(fj) == set(ft)
    for k in fj:
        scale = np.abs(fj[k]).max()
        assert np.abs(ft[k] - fj[k]).max() <= GRAD_RTOL * scale, k


def test_train_step_matches_reference_over_three_steps():
    jcfg, tcfg = cfgs()
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    jp, tp = ref_params(jcfg, seed=2)
    jo, to = jadamw.init(jp), tadamw.init(tp)
    jstep = jax.jit(jloop.make_train_step(jcfg, hp))
    tstep = tloop.make_train_step(tcfg, thp)
    lrs = []
    for i in range(3):
        bn = batch_np(jcfg, 2, 24, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in bn.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in bn.items()})
        assert set(tm) == {"loss", "nll", "aux", "grad_norm", "lr"}
        assert all(v.shape == () for v in tm.values())
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        lrs.append(float(jm["lr"]))
        assert int(to.step) == int(jo.step) == i + 1
    # A step moves a parameter by lr · (m̂ / (sqrt(v̂) + eps) + wd · p).  Where
    # a gradient entry is ~0 the normalised m̂ / sqrt(v̂) is O(1) and turns a
    # float32 gradient difference into up to ~lr; so over three steps the
    # parameters may differ by up to Σ lr.  Elsewhere they agree far tighter:
    # the median difference is held to 1e-3 of that.
    atol = sum(lrs)
    fj, ft = flat(jp), flat(tp)
    diffs = np.concatenate([np.abs(ft[k] - fj[k]).ravel() for k in fj])
    assert diffs.max() <= atol, diffs.max()
    assert np.median(diffs) <= 1e-3 * atol, np.median(diffs)
    np.testing.assert_allclose(np.concatenate([ft[k].ravel() for k in fj]),
                               np.concatenate([fj[k].ravel() for k in fj]), atol=atol)


def test_train_step_ignores_grad_compression_and_stubs_raise():
    """The steps take ``grad_compression`` and ignore it where the
    reference does; ``jit_train_step`` and ``train_loop`` on two members,
    once refusals, now run (the placed step is held to the reference in
    ``tests/test_torch_placement.py``)."""
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(grad_compression="int8", ticketed_embedding=False)
    assert callable(tloop.make_train_step(tcfg, hp))
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    compile_step = tloop.jit_train_step(cpu_mesh(), tcfg, hp, params, tadamw.init(params))
    assert callable(compile_step)
    assert callable(tloop.make_manual_dp_step(cpu_mesh(), tcfg, hp))
    data = iter(SyntheticLM(tcfg, batch=2, seq=8, track_stats=False, device=CPU))
    p2, o2, hist = tloop.train_loop(cpu_mesh(2), tcfg, hp, data, steps=1, log_every=1)
    assert isinstance(p2["embed"]["table"], sharding.PlacedTensor)
    assert int(o2.step.full(CPU)) == 1 and len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert [f.name for f in dataclasses.fields(tloop.TrainHParams)] == \
        [f.name for f in dataclasses.fields(jloop.TrainHParams)]
    assert tloop.TrainHParams() == tloop.TrainHParams(**dataclasses.asdict(jloop.TrainHParams()))


# -- train_loop, checkpoints across packages ----------------------------------------

def loop_setup():
    jcfg, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True)
    return jcfg, tcfg, hp


def test_train_loop_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    _, tcfg, hp = loop_setup()
    _, tp = ref_params(cfgs()[0], seed=3)

    def data(start=0):
        d = SyntheticLM(tcfg, batch=2, seq=32, seed=5, track_stats=False, device=CPU)
        d.state.step = start
        return iter(d)

    def fresh():
        return ttf.tree_map(lambda t: t.clone(), tp)

    mesh = cpu_mesh()
    whole, whole_opt, hist = ttrain.train_loop(mesh, tcfg, hp, data(), steps=4,
                                               params=fresh(), log_every=2)
    assert [h["step"] for h in hist] == [2, 4] and "step      4 loss=" in capsys.readouterr().out
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    ttrain.train_loop(mesh, tcfg, hp, data(), steps=2, params=fresh(), checkpoint_manager=mgr,
                      checkpoint_every=2, log_every=100)
    assert mgr.latest_step() == 2
    resumed, opt, _ = ttrain.train_loop(mesh, tcfg, hp, data(2), steps=4, params=fresh(),
                                        checkpoint_manager=mgr, checkpoint_every=2,
                                        log_every=100)
    assert mgr.latest_step() == 4 and int(opt.step) == int(whole_opt.step) == 4
    for a, b in zip(flat(resumed).values(), flat(whole).values()):
        np.testing.assert_array_equal(a, b)   # the plain versions are deterministic
    for a, b in zip(flat(opt.v).values(), flat(whole_opt.v).values()):
        np.testing.assert_array_equal(a, b)


def test_optimizer_state_keys_are_the_reference_names():
    _, tp = ref_params(cfgs()[0])
    keys = set(_flatten(tadamw.init(tp)))
    assert ".step" in keys and ".m/embed/table" in keys and ".v/embed/table" in keys
    assert not any(k.startswith(("0", "1", "2")) for k in keys)
    # plain tuples and lists keep their indices
    assert set(_flatten({"a": (torch.zeros(1), [torch.zeros(1)])})) == {"a/0", "a/1/0"}


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_adamw_commits_cross_packages(tmp_path, direction):
    jcfg, _ = cfgs()
    jp, tp = ref_params(jcfg, seed=4)
    rng = np.random.default_rng(0)
    moments = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat(tp).items()}

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}/{k}") for k, v in tree.items()}
        return moments[prefix]

    jo = jadamw.AdamWState(jnp.asarray(5, jnp.int32), fill(jp), jax.tree.map(lambda a: a * 2, fill(jp)))
    to = tadamw.AdamWState(torch.tensor(5, dtype=torch.int32),
                           ttf.tree_map(torch.from_numpy, fill(tp)),
                           ttf.tree_map(lambda a: torch.from_numpy(a * 2), fill(tp)))
    if direction == "reference_to_port":
        JCheckpointManager(str(tmp_path), async_save=False).save(5, jp, jo)
        p2, o2, step = CheckpointManager(str(tmp_path)).restore_latest(
            tp, tadamw.init(tp), device=CPU)
        want_p, want_o = jp, jo
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(5, tp, to)
        p2, o2, step = JCheckpointManager(str(tmp_path)).restore_latest(jp, jadamw.init(jp))
        want_p, want_o = tp, to
    assert step == 5 and int(o2.step) == 5 and type(o2).__name__ == "AdamWState"
    for got, want in ((p2, want_p), (o2.m, want_o.m), (o2.v, want_o.v)):
        fg, fw = flat(got), flat(want)
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k])


def test_train_loop_commits_restore_in_the_other_package(tmp_path):
    jcfg, tcfg, hp = loop_setup()
    jhp = jloop.TrainHParams(**dataclasses.asdict(hp))
    # the reference's train_loop commits at step 2; the port restores it
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jparams, jopt, _ = jloop.train_loop(
        jax_mesh(), jcfg, jhp, iter(JSyntheticLM(jcfg, batch=2, seq=32, track_stats=False)),
        steps=2, checkpoint_manager=JCheckpointManager(jdir, async_save=False),
        checkpoint_every=2, log_every=100)
    _, tp = ref_params(jcfg)
    p2, o2, step = CheckpointManager(jdir).restore_latest(tp, tadamw.init(tp), device=CPU)
    assert step == 2 and int(o2.step) == int(jopt.step) == 2
    for got, want in ((p2, jparams), (o2.m, jopt.m), (o2.v, jopt.v)):
        fg, fw = flat(got), flat(want)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k])
    # the port's train_loop commits at step 2; the reference restores it,
    # and the port resumes from it
    tmgr = CheckpointManager(tdir, async_save=False)
    tparams, topt, _ = ttrain.train_loop(
        cpu_mesh(), tcfg, hp, iter(SyntheticLM(tcfg, batch=2, seq=32, track_stats=False,
                                               device=CPU)),
        steps=2, params=p2, checkpoint_manager=tmgr, checkpoint_every=2, log_every=100)
    assert sorted(os.listdir(tdir)) == ["step_00000002"]
    jp0 = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    rp, ro, rstep = JCheckpointManager(tdir).restore_latest(jp0, jadamw.init(jp0))
    assert rstep == 2 and int(ro.step) == int(topt.step) == 2
    for got, want in ((rp, tparams), (ro.m, topt.m), (ro.v, topt.v)):
        fg, fw = flat(got), flat(want)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k])


# -- fault tolerance ---------------------------------------------------------------

def test_straggler_policy_flags_outliers_as_reference():
    for pol in (fault_tolerance.StragglerPolicy(threshold=2.0),
                JStragglerPolicy(threshold=2.0)):
        for _ in range(8):
            assert not pol.record(1.0)
        assert pol.record(5.0)
        assert pol.flagged == 1
    pol = fault_tolerance.StragglerPolicy()
    assert not any(pol.record(t) for t in (9.0, 1.0, 1.0))  # fewer than 4: never


def test_elastic_runner_restarts_on_worker_failure(capsys):
    elastic.reset_failures()
    meshes = []

    def make_mesh(devs):
        meshes.append([d.id for d in devs])
        return sharding.make_mesh((len(devs), 1), ("data", "model"), devices=devs)

    def body(mesh, straggler):
        assert isinstance(straggler, fault_tolerance.StragglerPolicy)
        if len(meshes) == 1:
            raise elastic.WorkerFailure([1])
        return mesh.size

    try:
        with sharding.virtual_devices(4, CPU):
            runner = fault_tolerance.ElasticRunner(make_mesh, None, max_restarts=2)
            assert runner.run(body) == 3
            assert runner.restarts == 1 and meshes == [[0, 1, 2, 3], [0, 2, 3]]
            assert "[elastic] worker failure ([1]); restart 1/2 on 3 devices" in \
                capsys.readouterr().out

            def always(mesh, straggler):
                raise elastic.WorkerFailure([0])

            runner = fault_tolerance.ElasticRunner(make_mesh, None, max_restarts=1)
            with pytest.raises(elastic.WorkerFailure):
                runner.run(always)
            assert runner.restarts == 2
    finally:
        elastic.reset_failures()


def test_train_package_exports():
    for name in ("TrainHParams", "make_loss_fn", "make_train_step", "jit_train_step",
                 "make_manual_dp_step", "train_loop", "StragglerPolicy", "ElasticRunner",
                 "WorkerFailure", "available_devices", "mark_failed", "largest_mesh"):
        assert name in ttrain.__all__ and hasattr(ttrain, name)


# -- B3's autograd node --------------------------------------------------------------

def test_grouped_matmul_gradient_equals_the_plain_version():
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(rng.standard_normal((13, 6)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
    sizes = torch.tensor([3, 0, 7, 2], dtype=torch.int32)   # one empty group, a row past them
    g = torch.from_numpy(rng.standard_normal((13, 5)).astype(np.float32))
    l1, r1 = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gm.grouped_matmul(l1, r1, sizes)
    assert out.grad_fn is not None
    d1 = torch.autograd.grad(out, (l1, r1), g)
    l2, r2 = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    d2 = torch.autograd.grad(gm.grouped_matmul_plain(l2, r2, sizes), (l2, r2), g)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert not d1[0][12].any() and not d1[1][1].any()
    # only the rhs: the lhs gets no gradient
    r3 = rhs.clone().requires_grad_()
    (d3,) = torch.autograd.grad(gm.grouped_matmul(lhs, r3, sizes), (r3,), g)
    assert torch.equal(d3, d2[1])
    assert gm.grouped_matmul.launches == 0
