"""LM parameter placement and the placed training step of repro_torch
(``parallel/sharding.py`` ``spec_for_path`` / ``param_specs`` /
``param_shardings`` / ``place``, ``train/loop.py`` ``jit_train_step`` and
``train_loop`` over a mesh of members, ``train/elastic.py``
``reshard_restore``) against the JAX package's, on the CPU.

Members are virtual CPU members (``virtual_devices(n, "cpu")``).  Models are
reduced configs in float32; parameters are the reference's, carried across
with ``params_from_numpy``; batches are made with numpy from a seed.
Tolerances are those of ``tests/test_torch_dp.py``: loss and grad_norm
rtol 1e-5, lr rtol 1e-6, parameters after k steps within the summed lr and
a median 1e-3 of it (AdamW's normalised update turns a float32 gradient
difference at a near-zero entry into up to lr).

The reference's own multi-device sharded step fails on this jax (ROADMAP
§3 fault 5), so the placed step is held to the reference's
``make_train_step`` jitted on one device and its ``jit_train_step`` on a
1 × 1 mesh with Auto axes, and to the port's one-member step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro.train import loop as jloop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding
from repro_torch.train import elastic
from repro_torch.train import loop as tloop

CPU = "cpu"
LOSS_RTOL = 1e-5


def cfgs(arch="qwen3_0_6b"):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def ref_params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def flat(tree, prefix=""):
    """path → leaf of a nested dict (numpy for tensors, JAX and placed leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, sharding.PlacedTensor):
        return {prefix: tree.full(CPU).numpy()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def batch_np(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def tbatch(bn):
    return {k: torch.from_numpy(v) for k, v in bn.items()}


def cpu_mesh(shape=(2, 2), axes=("data", "model")):
    n = int(np.prod(shape))
    with sharding.virtual_devices(n, CPU) as members:
        return sharding.make_mesh(shape, axes, devices=members)


def jax_mesh():
    # Auto axes, as tests/test_torch_serve_lm.py builds them (ROADMAP fault 5)
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def assert_params_close(got, want, atol):
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw)
    diffs = np.concatenate([np.abs(fg[k] - fw[k]).ravel() for k in fw])
    assert diffs.max() <= atol, diffs.max()
    assert np.median(diffs) <= 1e-3 * atol, np.median(diffs)


def assert_metrics_close(got, want, keys=("loss", "nll", "aux", "grad_norm")):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)


# -- placement rules ---------------------------------------------------------------

def reference_specs(jtree):
    return _flat_specs(jax.tree.map(tuple, jsharding.param_specs(jtree),
                                    is_leaf=lambda x: isinstance(x, P)))


def port_specs(ttree):
    return _flat_specs(sharding.param_specs(ttree))


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_equal_the_reference_for_every_config(arch):
    """The port's own ``init_params`` tree: its specs are ``tuple(P)`` of
    the reference's, leaf for leaf (the trees match key for key)."""
    jcfg, tcfg = cfgs(arch)
    jtree = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    ttree = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    want, got = reference_specs(jtree), port_specs(ttree)
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values())


def test_param_specs_of_a_quantized_tree_equal_the_reference():
    """``w_q8`` / ``w_scale`` take the fp kernel's rule; a size-1 scale dim
    never shards."""
    jcfg, _ = cfgs()
    jp, tp = ref_params(jcfg)
    jq = jlayers.quantize_dense_params(jp)
    tq = tlayers.quantize_dense_params(tp)
    want, got = reference_specs(jq), port_specs(tq)
    assert got == want
    assert any(k.endswith("/w_q8") and "model" in s for k, s in got.items())
    assert any(k.endswith("/w_scale") for k in got)


def test_spec_for_path_pads_scan_axes_and_keeps_size_one_dims_whole():
    for path, ndim, shape in (("layers/attn/wq/w", 3, (4, 8, 16)),
                              ("layers/attn/wo/w", 3, (4, 16, 8)),
                              ("layers/moe/w_up", 4, (2, 4, 8, 16)),
                              ("layers/attn/wq/w_scale", 3, (4, 1, 16)),
                              ("layers/attn/wk/b", 0, ()),
                              ("final_norm/scale", 1, (8,))):
        assert sharding.spec_for_path(path, ndim, shape) == \
            tuple(jsharding.spec_for_path(path, ndim, shape)), path


# -- placement ---------------------------------------------------------------------

def abstract_sharding(spec):
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    return jax.sharding.NamedSharding(mesh, P(*spec))


def test_placement_parts_match_named_sharding_and_gather_back():
    jcfg, _ = cfgs()
    _, tp = ref_params(jcfg, seed=1)
    mesh = cpu_mesh()
    placed = sharding.place(tp, sharding.param_shardings(mesh, tp))
    want = flat(tp)
    for path, leaf in flat_placed(placed).items():
        spec = leaf.sharding.spec
        part_shape = abstract_sharding(spec).shard_shape(tuple(leaf.shape))
        for coord in np.ndindex(2, 2):
            part = leaf.shard(coord)
            assert tuple(part.shape) == part_shape, path
            # member (data d, model k) holds part k of each model-sharded dim
            idx = tuple(slice(coord[1] * n, (coord[1] + 1) * n) if e == "model" else slice(None)
                        for e, n in zip(spec + (None,) * (leaf.ndim - len(spec)), part_shape))
            np.testing.assert_array_equal(part.numpy(), want[path][idx], err_msg=path)
    assert all(np.array_equal(a, want[k]) for k, a in flat(sharding.unplace(placed, CPU)).items())
    # a fresh copy: placing never shares storage with the input
    table = placed["embed"]["table"]
    assert all(t.data_ptr() != tp["embed"]["table"].data_ptr() for t in table.copies.values())


def flat_placed(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_placed(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_members_on_one_device_share_one_copy_of_each_part():
    """On a (data 2, model 2) mesh of one device the parameters are held
    once: a model-sharded leaf has two copies (one a part), a replicated
    leaf one, and the two data members of a part read the same tensor."""
    jcfg, _ = cfgs()
    _, tp = ref_params(jcfg, seed=1)
    placed = sharding.place(tp, sharding.param_shardings(cpu_mesh(), tp))
    table = placed["embed"]["table"]
    assert table.sharding.spec == ("model", None) and len(table.copies) == 2
    assert table.shard((0, 0)).data_ptr() == table.shard((1, 0)).data_ptr()
    assert table.shard((0, 0)).data_ptr() != table.shard((0, 1)).data_ptr()
    norm = placed["final_norm"]["scale"]
    assert len(norm.copies) == 1 and norm.gathered(torch.device(CPU)) is norm.shard((1, 1))
    held = sum(t.numel() for leaf in flat_placed(placed).values() for t in leaf.copies.values())
    assert held == sum(t.numel() for t in ttf._leaves(tp))


def test_placement_of_a_dim_that_does_not_divide_raises():
    mesh = cpu_mesh((1, 3))
    with pytest.raises(ValueError, match="embed/table"):
        sharding.place({"embed": {"table": torch.zeros(8, 4)}},
                       sharding.param_shardings(mesh, {"embed": {"table": torch.zeros(8, 4)}}))
    with pytest.raises(ValueError, match="names axis"):
        sharding.NamedSharding(mesh, ("pod",))
    # a placed leaf is kept as it is under an equal sharding, re-placed under another
    x = {"attn": {"wq": {"w": torch.arange(24.0).reshape(4, 6)}}}
    a = sharding.place(x, sharding.param_shardings(cpu_mesh(), x))
    assert sharding.place(a, sharding.param_shardings(cpu_mesh(), x))["attn"]["wq"]["w"] \
        is a["attn"]["wq"]["w"]
    b = sharding.place(a, sharding.param_shardings(cpu_mesh((1, 2)), x))["attn"]["wq"]["w"]
    assert torch.equal(b.full(CPU), x["attn"]["wq"]["w"])


# -- the placed step -----------------------------------------------------------------

@pytest.mark.parametrize("ticketed", [True, False])
def test_placed_step_matches_one_member_and_reference_steps(ticketed):
    """Three placed steps on (data 2, model 2) against the port's
    ``make_train_step`` on the whole batch and the reference's
    ``make_train_step`` jitted on one device (and, without the ticketed
    embedding, its ``jit_train_step`` on a 1 × 1 mesh), from the same
    ``params_from_numpy`` weights and numpy batches."""
    jcfg, tcfg = cfgs()
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50,
                            ticketed_embedding=ticketed)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    jp, tp = ref_params(jcfg, seed=6)
    jo = jadamw.init(jp)
    p_one = ttf.tree_map(lambda t: t.clone(), tp)
    o_one = tadamw.init(p_one)
    mesh = cpu_mesh()
    bn0 = batch_np(jcfg.vocab_size, 8, 16, seed=40)
    step = tloop.jit_train_step(mesh, tcfg, thp, tp, tadamw.init(tp))(tbatch(bn0))
    one = tloop.make_train_step(tcfg, thp)
    jstep = jax.jit(jloop.make_train_step(jcfg, hp))
    if not ticketed:
        jb0 = {k: jnp.asarray(v) for k, v in bn0.items()}
        pj_p = jax.tree.map(jnp.copy, jp)
        pj_step = jloop.jit_train_step(jax_mesh(), jcfg, hp, pj_p, jadamw.init(pj_p))(jb0)
        pj_o = jadamw.init(pj_p)
    p, o, lrs = tp, tadamw.init(tp), []
    for i in range(3):
        bn = batch_np(jcfg.vocab_size, 8, 16, seed=40 + i)
        p, o, m = step(p, o, tbatch(bn))
        p_one, o_one, m_one = one(p_one, o_one, tbatch(bn))
        jb = {k: jnp.asarray(v) for k, v in bn.items()}
        jp, jo, jm = jstep(jp, jo, jb)
        assert set(m) == {"loss", "nll", "aux", "grad_norm", "lr"}
        assert all(v.shape == () and v.device.type == "cpu" for v in m.values())
        assert_metrics_close(m, m_one)
        assert_metrics_close(m, jm)
        if not ticketed:
            pj_p, pj_o, pjm = pj_step(pj_p, pj_o, jb)
            assert_metrics_close(m, pjm)
        lrs.append(float(jm["lr"]))
    assert isinstance(p["embed"]["table"], sharding.PlacedTensor)
    assert int(o.step.full(CPU)) == int(jo.step) == 3
    assert_params_close(p, p_one, sum(lrs))
    assert_params_close(p, jp, sum(lrs))
    assert_params_close(o.m, o_one.m, sum(lrs))
    if not ticketed:
        assert_params_close(p, pj_p, sum(lrs))


def test_placed_moe_step_matches_the_reference_step_from_the_same_state():
    """granite-moe-1b-a400m reduced on (data 2, model 2): the expert
    tensors ``moe/w_*`` placed ``("model", None, None)``; each placed step
    against the reference's jitted step on the whole batch and the port's
    one-member step from the same state (as ``tests/test_torch_moe_train.py``
    compares: after a step, a router top-k that nearly ties may pick
    another expert).  With two data-parallel members the load-balance loss
    is still the whole batch's (``moe.split_aux``), which the mean of the
    members' own losses is not: the test checks both.  The dense
    embedding: on jax 0.9 a jitted reference MoE step with the ticketed
    embedding's interpret-mode kernel fails to run after other jitted
    ticketed steps in one process ("supplied 39 buffers but compiled
    program expected 42", ROADMAP §3 fault 5); the ticketed MoE step is
    held to the reference in ``tests/test_torch_moe_train.py``."""
    jcfg, tcfg = cfgs("granite_moe_1b_a400m")
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=False)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    _, tp = ref_params(jcfg, seed=7)
    mesh = cpu_mesh()
    p, o = tp, tadamw.init(tp)
    step = None
    jstep = jax.jit(jloop.make_train_step(jcfg, hp))
    one = tloop.make_train_step(tcfg, thp)
    loss_fn = tloop.make_loss_fn(tcfg, thp)
    for i in range(3):
        bn = batch_np(jcfg.vocab_size, 4, 16, seed=50 + i)
        if step is None:
            step = tloop.jit_train_step(mesh, tcfg, thp, p, o)(tbatch(bn))
        before_p = sharding.unplace(p, CPU) if i else ttf.tree_map(lambda t: t.clone(), p)
        before_o = sharding.unplace(o, CPU) if i else tadamw.init(p)
        to_jax = lambda tree: jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)  # noqa: E731
        same_p, _, jm = jstep(to_jax(before_p), jadamw.AdamWState(*map(to_jax, before_o)),
                              {k: jnp.asarray(v) for k, v in bn.items()})
        with torch.no_grad():
            halves = [loss_fn(before_p, tbatch({k: v[r] for k, v in bn.items()}))[1]["aux"]
                      for r in (slice(0, 2), slice(2, 4))]
        one_p, _, m_one = one(before_p, before_o, tbatch(bn))
        p, o, m = step(p, o, tbatch(bn))
        assert float(m["aux"]) > 0
        # the members' mean load-balance loss is another number than the batch's
        assert abs(float(sum(halves)) / 2 - float(jm["aux"])) > 1e-3 * float(jm["aux"])
        assert_metrics_close(m, jm)
        assert_metrics_close(m, m_one)
        lr = float(jm["lr"])
        assert_params_close(p, same_p, lr + 1e-7)
        assert_params_close(p, one_p, lr + 1e-7)
    w_up = p["layers"]["moe"]["w_up"]
    assert w_up.sharding.spec == (None, "model", None, None) and len(w_up.copies) == 2


def test_placed_step_weights_members_by_their_valid_targets():
    """Masked targets (``targets < 0``) in unequal numbers over the two
    data-parallel members: the placed step's ``nll`` is the batch's masked
    mean (each member's mean weighted by its valid targets), as the port's
    one-member step and the reference's jitted step compute it, over two
    steps on (data 2, model 2); a member with no valid target adds
    nothing."""
    jcfg, tcfg = cfgs()
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=False)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    jp, tp = ref_params(jcfg, seed=8)
    jo = jadamw.init(jp)
    p_one = ttf.tree_map(lambda t: t.clone(), tp)
    o_one = tadamw.init(p_one)
    jstep = jax.jit(jloop.make_train_step(jcfg, hp))
    one = tloop.make_train_step(tcfg, thp)
    p, o, lrs, step = tp, tadamw.init(tp), [], None
    for i, masked in enumerate([(slice(0, 4), slice(0, 13)), (slice(0, 2), slice(None))]):
        bn = batch_np(jcfg.vocab_size, 8, 16, seed=60 + i)
        bn["targets"] = bn["targets"].copy()  # a view of the tokens' array
        bn["targets"][masked] = -1  # rows of the first member only
        if step is None:
            step = tloop.jit_train_step(cpu_mesh(), tcfg, thp, p, o)(tbatch(bn))
        p, o, m = step(p, o, tbatch(bn))
        p_one, o_one, m_one = one(p_one, o_one, tbatch(bn))
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in bn.items()})
        assert_metrics_close(m, m_one)
        assert_metrics_close(m, jm)
        lrs.append(float(jm["lr"]))
    assert_params_close(p, p_one, sum(lrs))
    assert_params_close(p, jp, sum(lrs))


def test_placed_step_checks_the_batch():
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(ticketed_embedding=False)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    opt = tadamw.init(params)
    b = tbatch(batch_np(tcfg.vocab_size, 6, 8, seed=3))
    step = tloop.jit_train_step(cpu_mesh((4, 1)), tcfg, hp, params, opt)(b)
    with pytest.raises(ValueError, match="do not split"):
        step(params, opt, b)
    with pytest.raises(ValueError, match="batch keys"):
        step(params, opt, {"tokens": b["tokens"]})
    with pytest.raises(ValueError, match="data"):
        tloop.jit_train_step(cpu_mesh((2,), ("model",)), tcfg, hp, params, opt)


# -- train_loop over members, reshard_restore, commits across packages -----------------

def loop_data(tcfg, start=0):
    d = SyntheticLM(tcfg, batch=4, seq=16, seed=5, track_stats=False, device=CPU)
    d.state.step = start
    return iter(d)


def test_train_loop_on_four_members_resumes_on_two_as_six_steps_on_one(tmp_path):
    """Four steps on (data 2, model 2) with a commit every two; then
    ``reshard_restore`` of the step-4 commit onto (data 1, model 2) and
    ``train_loop`` to step 6 there: the result equals six steps of
    ``train_loop`` on one member."""
    jcfg, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True)
    _, tp = ref_params(jcfg, seed=3)
    fresh = lambda: ttf.tree_map(lambda t: t.clone(), tp)  # noqa: E731
    whole, whole_opt, hist1 = tloop.train_loop(cpu_mesh((1, 1)), tcfg, hp, loop_data(tcfg),
                                               steps=6, params=fresh(), log_every=1)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    four, four_opt, hist4 = tloop.train_loop(cpu_mesh((2, 2)), tcfg, hp, loop_data(tcfg),
                                             steps=4, params=fresh(), checkpoint_manager=mgr,
                                             checkpoint_every=2, log_every=1)
    assert mgr.latest_step() == 4 and sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]
    assert isinstance(four["embed"]["table"], sharding.PlacedTensor)
    two = cpu_mesh((1, 2))
    rp, ro, rstep = elastic.reshard_restore(mgr, fresh(), tadamw.init(fresh()), two)
    assert rstep == 4 and rp["embed"]["table"].sharding.mesh is two
    assert all(np.array_equal(a, b) for a, b in zip(flat(rp).values(), flat(four).values()))
    assert all(np.array_equal(a, b) for a, b in zip(flat(ro.v).values(), flat(four_opt.v).values()))
    with pytest.raises(ValueError, match="not both"):
        mgr.restore_latest(fresh(), device=CPU, shardings=sharding.param_shardings(two, tp))
    six, six_opt, hist2 = tloop.train_loop(two, tcfg, hp, loop_data(tcfg, 4), steps=6,
                                           params=fresh(), checkpoint_manager=mgr,
                                           checkpoint_every=2, log_every=1)
    assert [h["step"] for h in hist4 + hist2] == [1, 2, 3, 4, 5, 6] == [h["step"] for h in hist1]
    for got, want in zip(hist4 + hist2, hist1):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert int(six_opt.step.full(CPU)) == int(whole_opt.step) == 6
    lrs = sum(h["lr"] for h in hist1)
    assert_params_close(six, whole, lrs)
    assert_params_close(six_opt.m, whole_opt.m, lrs)


def test_a_reference_commit_resumes_on_four_port_members(tmp_path):
    """The reference's ``train_loop`` (its ``jit_train_step`` on a 1 × 1
    mesh) commits at step 2; the port's ``train_loop`` on (data 2, model 2)
    restores that commit and trains to step 4, as the reference resuming
    from it does; the port's step-4 commit restores in the reference."""
    jcfg, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=False)
    jhp = jloop.TrainHParams(**dataclasses.asdict(hp))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"

    def jdata(start=0):
        d = JSyntheticLM(jcfg, batch=4, seq=16, seed=5, track_stats=False)
        d.state.step = start
        return iter(d)

    jloop.train_loop(jax_mesh(), jcfg, jhp, jdata(), steps=2,
                     checkpoint_manager=JCheckpointManager(str(jdir), async_save=False),
                     checkpoint_every=2, log_every=100)
    jp, jo, _ = jloop.train_loop(jax_mesh(), jcfg, jhp, jdata(2), steps=4,
                                 checkpoint_manager=JCheckpointManager(str(jdir),
                                                                       async_save=False),
                                 checkpoint_every=100, log_every=100)
    import shutil

    shutil.copytree(jdir / "step_00000002", tdir / "step_00000002")
    _, tp = ref_params(jcfg, seed=9)  # a template: the commit's values replace it
    mgr = CheckpointManager(str(tdir), async_save=False)
    p, o, hist = tloop.train_loop(cpu_mesh(), tcfg, hp, loop_data(tcfg, 2), steps=4, params=tp,
                                  checkpoint_manager=mgr, checkpoint_every=4, log_every=1)
    assert [h["step"] for h in hist] == [3, 4] and int(o.step.full(CPU)) == int(jo.step) == 4
    lrs = sum(h["lr"] for h in hist)
    assert_params_close(p, jp, lrs)
    jp0 = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    rp, ro, rstep = JCheckpointManager(str(tdir)).restore_latest(jp0, jadamw.init(jp0))
    assert rstep == 4 and int(ro.step) == 4
    for got, want in ((rp, p), (ro.m, o.m), (ro.v, o.v)):
        fg, fw = flat(got), flat(want)
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k])


@pytest.mark.parametrize("compression", [None, "int8"])
def test_manual_dp_step_on_a_placed_tree_equals_the_shared_copy_step(compression):
    """``make_manual_dp_step`` given parameters and AdamW state placed one
    copy a device (the path of members on several devices) takes the same
    steps as on the one shared plain copy, and returns them placed."""
    jcfg, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True,
                            grad_compression=compression)
    mesh = cpu_mesh((2, 2), ("pod", "data"))
    step = tloop.make_manual_dp_step(mesh, tcfg, hp)
    _, plain = ref_params(jcfg, seed=8)
    everywhere = sharding.NamedSharding(mesh, ())
    placed = sharding.place(plain, everywhere)
    p_opt = sharding.place(tadamw.init(plain), everywhere)
    o = tadamw.init(plain)
    for i in range(2):
        b = tbatch(batch_np(jcfg.vocab_size, 8, 16, seed=60 + i))
        placed, p_opt, pm = step(placed, p_opt, b)
        plain, o, m = step(plain, o, b)
        for k in ("loss", "grad_norm", "lr"):
            assert float(pm[k]) == float(m[k]), k
    assert len(placed["embed"]["table"].copies) == 1
    assert int(p_opt.step.full(CPU)) == int(o.step) == 2
    for a, b in zip(flat(placed).values(), flat(plain).values()):
        np.testing.assert_array_equal(a, b)
