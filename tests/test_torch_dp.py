"""The data-parallel training step of repro_torch (``train/loop.py``
``make_manual_dp_step`` with ``optim/compression.py`` ``compressed_psum``
over the pod axis; ``parallel/sharding.py`` ``dp_axes`` / ``batch_spec``)
against the JAX package's, on the CPU.

The port's mesh is single-controller: its members here are virtual CPU
members (``virtual_devices(n, "cpu")``) that share one copy of the
replicated parameters.  Reduced qwen3-0.6b in float32, parameters from the
reference's ``init_params`` carried across with ``params_from_numpy``,
batches made with numpy from a seed.

- On a (1, 1) ("pod", "data") mesh the step equals the reference's
  shard_map step on a one-device JAX mesh (built with Auto axes: ROADMAP
  §3 fault 5), with and without int8 compression, over 3 steps: loss and
  grad_norm rtol 1e-5, lr rtol 1e-6, parameters within Σ lr and a median
  1e-3 of it, as ``tests/test_torch_train.py`` holds the one-member step
  (AdamW turns a float32 gradient difference at a near-zero entry into up
  to lr).  Under int8 a gradient that lands within float32 rounding of a
  code's rounding boundary may take the neighbouring code; that moves
  grad_norm by far less than 1e-5 here, and a parameter by at most lr.
- On (2, 2) members without compression the step equals the one-member
  ``make_train_step`` on the whole batch (the mean of equal parts' mean
  losses is the whole batch's), with the same tolerances.
- The in-process mirror of ``tests/test_distributed.py``'s
  ``test_manual_dp_train_step_with_compression``: a (2, 4) mesh, int8, 4
  steps on one batch, every loss finite and the last below the first."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro.train import loop as jloop
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding
from repro_torch.train import loop as tloop

LOSS_RTOL = 1e-5


def cfgs():
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3_0_6b", reduced=True), dtype="float32")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def ref_params(jcfg, seed):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def batch_np(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def tbatch(bn):
    return {k: torch.from_numpy(v) for k, v in bn.items()}


def cpu_mesh(shape, axes):
    n = int(np.prod(shape))
    with sharding.virtual_devices(n, "cpu") as members:
        return sharding.make_mesh(shape, axes, devices=members)


def assert_params_close(got, want, atol):
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw)
    diffs = np.concatenate([np.abs(fg[k] - fw[k]).ravel() for k in fw])
    assert diffs.max() <= atol, diffs.max()
    assert np.median(diffs) <= 1e-3 * atol, np.median(diffs)


def test_dp_axes_and_batch_spec_match_reference():
    for axes in (("pod", "data"), ("data", "model"), ("pod", "data", "model")):
        shape = (1,) * len(axes)
        jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(shape), axes)
        tmesh = cpu_mesh(shape, axes)
        assert sharding.dp_axes(tmesh) == jsharding.dp_axes(jmesh)
        assert sharding.batch_spec(tmesh) == tuple(jsharding.batch_spec(jmesh))


@pytest.mark.parametrize("compression", [None, "int8"])
def test_manual_dp_step_matches_reference_on_one_member(compression):
    jcfg, tcfg = cfgs()
    # the dense embedding: the reference's ticketed one runs its Pallas ticket
    # kernel in interpret mode, whose callbacks break the reuse of a jitted
    # shard_map step on jax 0.9 ("supplied 42 buffers but compiled program
    # expected 45"), and an eager shard_map step takes over a minute; the
    # ticketed gradient is held to the reference in tests/test_torch_train.py
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=False,
                            grad_compression=compression)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("pod", "data"))
    jstep = jax.jit(jloop.make_manual_dp_step(jmesh, jcfg, hp))  # eager shard_map is slow
    tstep = tloop.make_manual_dp_step(cpu_mesh((1, 1), ("pod", "data")), tcfg, thp)
    jp, tp = ref_params(jcfg, seed=4)
    jo, to = jadamw.init(jp), tadamw.init(tp)
    lrs = []
    for i in range(3):
        bn = batch_np(jcfg.vocab_size, 4, 16, seed=20 + i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in bn.items()})
        tp, to, tm = tstep(tp, to, tbatch(bn))
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        assert all(v.shape == () for v in tm.values())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        lrs.append(float(jm["lr"]))
        assert int(to.step) == int(jo.step) == i + 1
    assert_params_close(tp, jp, sum(lrs))


@pytest.mark.parametrize("shape,axes", [((2, 2), ("pod", "data")),
                                        ((4, 2), ("data", "model"))])
def test_manual_dp_step_equals_one_member_step_on_the_whole_batch(shape, axes):
    jcfg, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True)
    mesh = cpu_mesh(shape, axes)
    dp_step = tloop.make_manual_dp_step(mesh, tcfg, hp)
    one_step = tloop.make_train_step(tcfg, hp)
    _, p_dp = ref_params(jcfg, seed=5)
    p_one = ttf.tree_map(lambda t: t.clone(), p_dp)
    o_dp, o_one = tadamw.init(p_dp), tadamw.init(p_one)
    npod = mesh.shape.get("pod", 1)
    lrs = []
    for i in range(3):
        b = tbatch(batch_np(jcfg.vocab_size, 8, 16, seed=30 + i))
        first_pod = {k: v[:v.shape[0] // npod] for k, v in b.items()}
        want_loss, _ = ttf.lm_loss(p_one, tcfg, first_pod, ticketed_embedding=True)
        p_dp, o_dp, m_dp = dp_step(p_dp, o_dp, b)
        p_one, o_one, m_one = one_step(p_one, o_one, b)
        # loss: the mean over data of the first pod's members, as the reference
        np.testing.assert_allclose(float(m_dp["loss"]), float(want_loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m_dp["grad_norm"]), float(m_one["grad_norm"]),
                                   rtol=LOSS_RTOL)
        assert float(m_dp["lr"]) == float(m_one["lr"])
        lrs.append(float(m_one["lr"]))
    assert int(o_dp.step) == int(o_one.step) == 3
    assert_params_close(p_dp, p_one, sum(lrs))


def test_manual_dp_step_int8_on_a_pod_mesh_trains():
    """tests/test_distributed.py's shard_map test in one process: a (2, 4)
    ("pod", "data") mesh of virtual members, int8 over the pod axis, 4
    steps on one batch of 8 × 32 tokens."""
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(ticketed_embedding=False, grad_compression="int8")
    step = tloop.make_manual_dp_step(cpu_mesh((2, 4), ("pod", "data")), tcfg, hp)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    opt = tadamw.init(params)
    batch = tbatch(batch_np(tcfg.vocab_size, 8, 32, seed=1))
    batch["targets"] = torch.roll(batch["tokens"], -1, 1)
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_manual_dp_step_updates_one_shared_copy_once():
    """Virtual members share the parameters' storage: the step writes the
    caller's tensors in place, once (the AdamW step counter advances by one
    a step however many members computed)."""
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=0, ticketed_embedding=False)
    step = tloop.make_manual_dp_step(cpu_mesh((2, 2), ("pod", "data")), tcfg, hp)
    params = ttf.init_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    opt = tadamw.init(params)
    ptrs = [t.data_ptr() for t in ttf._leaves(params)]
    before = [t.clone() for t in ttf._leaves(params)]
    params2, opt2, _ = step(params, opt, tbatch(batch_np(tcfg.vocab_size, 4, 8, seed=2)))
    assert [t.data_ptr() for t in ttf._leaves(params2)] == ptrs and int(opt2.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(ttf._leaves(params2), before))


def test_manual_dp_step_refuses_a_member_on_another_device():
    """A member on another device than the parameters' gets a copy of the
    parameters of its own (placement, one copy a device).  Where no card
    exists, a mesh naming ``cuda:0`` raises the port's no-card
    ``RuntimeError`` before any member computes, and the caller's state is
    as it was; on a card the step runs with a copy on each device."""
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(ticketed_embedding=False)
    members = [sharding.MeshDevice(0, torch.device("cpu")),
               sharding.MeshDevice(1, torch.device("cuda", 0))]
    step = tloop.make_manual_dp_step(sharding.make_mesh((1, 2), ("pod", "data"), devices=members),
                                     tcfg, hp)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    opt = tadamw.init(params)
    before = [t.clone() for t in ttf._leaves(params)]
    batch = tbatch(batch_np(tcfg.vocab_size, 4, 8, seed=3))
    if torch.cuda.is_available():
        params2, opt2, _ = step(params, opt, batch)
        assert set(params2["embed"]["table"].copies) == {("cpu", (0, 0)), ("cuda:0", (0, 0))}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step(params, opt, batch)
    assert int(opt.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(ttf._leaves(params), before))


def test_manual_dp_step_checks_the_mesh_and_the_batch():
    _, tcfg = cfgs()
    hp = tloop.TrainHParams(ticketed_embedding=False)
    with pytest.raises(ValueError, match="data"):
        tloop.make_manual_dp_step(cpu_mesh((2,), ("model",)), tcfg, hp)
    step = tloop.make_manual_dp_step(cpu_mesh((2, 2), ("pod", "data")), tcfg, hp)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        step(params, tadamw.init(params), tbatch(batch_np(tcfg.vocab_size, 6, 8, seed=3)))
