"""Per-layer rematerialisation in repro_torch (``models/transformer.py``
``_remat``, ``_remat_policy``: the reference's ``jax.checkpoint`` on each
block, ``cfg.remat_policy``) against the JAX package and against the
port's own blocks called directly, on the CPU.

Parameters are the reference's, carried across with ``params_from_numpy``;
inputs are made with numpy from a seed.  The models run in float32.
Tolerances, stated where used: against the reference, the loss to rtol
1e-5 and every gradient leaf to max|Δ| <= 1e-5 · max|g| (as
``tests/test_torch_train.py``: float32 matmuls and reductions in another
order); remat against the direct call, every leaf to max|Δ| <= 1e-6 ·
max|g| (the recompute runs the same ops on the same inputs).

"Direct call" swaps ``transformer._remat`` for a wrapper that returns the
block itself, which is what the stacks ran before remat was ported."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import SHAPES
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.parallel import sharding
from repro_torch.train import loop as tloop

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

CPU = "cpu"
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5       # port vs reference: max|Δ| <= GRAD_RTOL · max|g| per leaf
REMAT_RTOL = 1e-6      # remat vs direct call: max|Δ| <= REMAT_RTOL · max|g| per leaf
GIB = 2 ** 30


def cfgs(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32", **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def ref_params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
                                    * 0.1).astype(np.float32)
    if cfg.encoder_layers:
        batch["encoder_frames"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def to_torch(bn):
    return {k: torch.from_numpy(v.copy()) for k, v in bn.items()}


def flat(tree, prefix=""):
    """path → numpy array of a nested dict (JAX or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def port_grads(params, cfg, batch, **kw):
    """(loss, gradient tree) of the port's ``lm_loss``."""
    tree = ttf.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = ttf.lm_loss(tree, cfg, batch, **kw)
    flat_g = iter(torch.autograd.grad(loss, list(ttf._leaves(tree))))
    return float(loss.detach()), ttf.tree_map(lambda _: next(flat_g), params)


def direct(block, policy=None):
    return block


def assert_leaves_close(got, want, rtol):
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        scale = np.abs(fw[k]).max()
        assert np.abs(fg[k] - fw[k]).max() <= rtol * scale, (k, np.abs(fg[k] - fw[k]).max(), scale)


# -- the port under remat against the reference, which remats ------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_gradients_under_remat_match_the_reference(arch):
    """Every family's stack (dense, MoE, sliding window, vision front end,
    enc-dec encoder and decoder, zamba2's hybrid, rwkv6) under remat
    against ``jax.value_and_grad`` of the reference's ``lm_loss`` (which
    checkpoints each block), dense embedding on the reference's side and
    the ticketed one on the port's (the same function)."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = ref_params(jcfg, seed=1)
    bn = batch_np(jcfg, seed=5)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb, ticketed_embedding=False), has_aux=True))(jp)
    calls = []
    real = ttf.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ttf.checkpoint = spy
    try:
        tl, tg = port_grads(tp, tcfg, to_torch(bn))
    finally:
        ttf.checkpoint = real
    # one checkpoint a block (zamba2: each Mamba2 block and each call of the
    # shared attention block; seamless: the encoder's blocks too)
    assert len(calls) == tcfg.n_layers + tcfg.encoder_layers
    np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    assert_leaves_close(tg, jax.tree.map(np.asarray, jg), GRAD_RTOL)


# -- remat against the direct call -----------------------------------------------------


def cpu_mesh(shape, axes):
    with sharding.virtual_devices(int(np.prod(shape)), CPU) as members:
        return sharding.make_mesh(shape, axes, devices=members)


@pytest.mark.parametrize("arch,policy,moe_impl", [
    ("qwen3_0_6b", "none", "dense"), ("qwen3_0_6b", "dots", "dense"),
    ("granite_moe_1b_a400m", "none", "dense"), ("granite_moe_1b_a400m", "dots", "dense"),
    ("granite_moe_1b_a400m", "none", "ep"),  # 4 CPU members, (data 1, model 4)
    ("seamless_m4t_large_v2", "dots", "dense"), ("zamba2_1_2b", "dots", "dense"),
    ("rwkv6_1_6b", "none", "dense"),
])
def test_remat_gradients_equal_the_direct_call(arch, policy, moe_impl, monkeypatch):
    jcfg, tcfg = cfgs(arch, remat_policy=policy)
    _, tp = ref_params(jcfg, seed=3)
    batch = to_torch(batch_np(jcfg, seed=7))
    kw = {}
    if moe_impl == "ep":
        mesh = cpu_mesh((1, 4), ("data", "model"))
        kw = {"moe_impl": "ep", "ep_info": {"mesh": mesh, "dp": ("data",),
                                            "capacity_per_expert": 64}}
    try:
        loss, got = port_grads(tp, tcfg, batch, **kw)
        monkeypatch.setattr(ttf, "_remat", direct)
        want_loss, want = port_grads(tp, tcfg, batch, **kw)
    finally:
        sharding.reset_virtual_devices()
    assert loss == want_loss
    assert_leaves_close(got, want, REMAT_RTOL)


# -- which ops the backward runs again ----------------------------------------------


class OpCounter(TorchDispatchMode):
    """Counts aten ops by (phase, inside a block, name); ``phase`` is set by
    the test, and a block is a call of the spied ``_attn_block``."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.phase = "forward"
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[(self.phase, self.depth > 0, func.overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))

    def spy(self, block):
        def run(*args, **kwargs):
            self.depth += 1
            try:
                return block(*args, **kwargs)
            finally:
                self.depth -= 1
        return run

    def of(self, phase, name):
        return self.counts[(phase, True, name)]


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_1b_a400m"])
@pytest.mark.parametrize("policy", ["none", "dots"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_policy_decides_which_products_are_recomputed(arch, policy, early_stop, monkeypatch):
    """``"none"`` (save nothing) recomputes every stack ``mm`` of the
    forward and ``"dots"`` none of them; both recompute every ``bmm``
    (attention's batched products, which have batch dims).  With
    checkpoint's early stop (the default) the recompute of a block ends at
    the last tensor its backward reads, so under ``"none"`` a block's last
    product may be left out when nothing reads its output (XLA drops the
    same dead recompute): at most one ``mm`` a block."""
    _, tcfg = cfgs(arch, remat_policy=policy)
    jcfg, _ = cfgs(arch)
    _, tp = ref_params(jcfg, seed=3)
    batch = to_torch(batch_np(jcfg, seed=7))
    mode = OpCounter()
    monkeypatch.setattr(ttf, "_attn_block", mode.spy(ttf._attn_block))
    tree = ttf.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop), mode:
        loss, _ = ttf.lm_loss(tree, tcfg, batch)
        mode.phase = "backward"
        torch.autograd.grad(loss, list(ttf._leaves(tree)))
    fwd_mm, fwd_bmm = mode.of("forward", "mm"), mode.of("forward", "bmm")
    re_mm, re_bmm = mode.of("backward", "mm"), mode.of("backward", "bmm")
    assert fwd_mm > 0 and fwd_bmm > 0
    assert re_bmm == fwd_bmm
    if policy == "dots":
        assert re_mm == 0
    elif early_stop:
        assert fwd_mm - tcfg.n_layers <= re_mm <= fwd_mm
    else:
        assert re_mm == fwd_mm
    assert mode.of("backward", "_softmax") == mode.of("forward", "_softmax") > 0


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "zamba2_1_2b", "rwkv6_1_6b"])
def test_no_checkpoint_without_a_gradient(arch, monkeypatch):
    """Under ``torch.no_grad()`` (and with no tensor requiring grad) a block
    is a plain call: ``forward`` and ``decode_step`` run no checkpoint and
    the same ops, op for op, as with the blocks called directly."""
    jcfg, tcfg = cfgs(arch)
    _, tp = ref_params(jcfg, seed=3)
    batch = to_torch(batch_np(jcfg, seed=7))
    calls = []
    real = ttf.checkpoint
    monkeypatch.setattr(ttf, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def ops():
        mode = OpCounter()
        caches = ttf.init_caches(tcfg, B, S, "float32", device=CPU)
        with mode:
            with torch.no_grad():
                ttf.forward(tp, tcfg, batch)
                ttf.decode_step(tp, tcfg, batch["tokens"][:, :4], caches)
            ttf.forward(tp, tcfg, batch)  # gradients on, nothing requires grad
        return mode.counts

    with_remat = ops()
    monkeypatch.setattr(ttf, "_remat", direct)
    assert ops() == with_remat
    assert not calls


def test_recomputed_moe_routing_and_group_sizes_equal_the_forward(monkeypatch):
    """A MoE block's recompute routes again (``route``'s histogram, the
    segment kernel's plain version here) and runs B3 again (three calls);
    the group sizes of every recomputed call equal the forward's, layer
    for layer (the recompute runs the last layer first)."""
    jcfg, tcfg = cfgs("granite_moe_1b_a400m")
    _, tp = ref_params(jcfg, seed=3)
    batch = to_torch(batch_np(jcfg, seed=11))
    sizes, hists = [], []
    gmm, seg = tmoe.grouped_matmul, tmoe.segment_agg

    def gmm_spy(lhs, rhs, group_sizes):
        sizes.append(group_sizes.clone())
        return gmm(lhs, rhs, group_sizes)

    def seg_spy(*a, **kw):
        out = seg(*a, **kw)
        hists.append(out.clone())
        return out

    monkeypatch.setattr(tmoe, "grouped_matmul", gmm_spy)
    monkeypatch.setattr(tmoe, "segment_agg", seg_spy)
    port_grads(tp, tcfg, batch)
    n = sum(tcfg.is_moe_layer(i) for i in range(tcfg.n_layers))
    assert n == tcfg.n_layers and len(sizes) == 6 * n and len(hists) == 2 * n
    fwd, rec = sizes[:3 * n], sizes[3 * n:]
    for i in range(n):
        j = n - 1 - i
        for a, b in zip(fwd[3 * i:3 * i + 3], rec[3 * j:3 * j + 3]):
            assert torch.equal(a, b)
        assert torch.equal(hists[i], hists[2 * n - 1 - i])
    assert int(fwd[0].sum()) == B * S * tcfg.moe_top_k


# -- the dry run: the remat variants trace a rematerialised step -----------------------


class OpFlops(tdryrun.CostMode):
    """``CostMode`` with its FLOPs tallied by op name as well."""

    def __init__(self):
        super().__init__()
        self.by_op = collections.Counter()

    def _count(self, func, args, kwargs, out):
        before = self.flops
        super()._count(func, args, kwargs, out)
        self.by_op[func.overloadpacket.__name__] += self.flops - before


def production_mesh():
    with sharding.virtual_devices(256, tdryrun.META):
        return make_production_mesh()


def traced(cfg, variant):
    step = tdryrun.lower_cell(production_mesh(), cfg, SHAPES["train_4k"], variant)
    mode = OpFlops()
    with mode:
        for t in step.held:
            mode.hold(t)
        step.fn(*step.args)
    return mode


def test_dryrun_remat_variants_trace_a_rematerialised_step(monkeypatch):
    """On meta tensors (reduced qwen3-0.6b, a train_4k member): the
    ``remat_dots`` variant traces another step than the default one (full
    remat), and the default another than the blocks called directly.
    ``CostMode`` under checkpoint's selective mode counts one op an op run:
    ``"dots"`` adds no ``mm`` FLOPs to the direct call's (the saved
    products are not run again) and the same ``bmm`` FLOPs as full remat;
    full remat adds ``mm`` FLOPs.  The ``"dots"`` step keeps its products,
    so its peak lies above full remat's and below the direct call's."""
    cfg = get_config("qwen3_0_6b", reduced=True)
    default, dots = traced(cfg, None), traced(cfg, "remat_dots")
    bf16 = traced(dataclasses.replace(cfg, logits_dtype="bfloat16"), None)
    remat_bf16 = traced(cfg, "remat_bf16logits")
    monkeypatch.setattr(ttf, "_remat", direct)
    plain = traced(cfg, None)
    assert plain.flops < dots.flops < default.flops
    assert plain.by_op["mm"] == dots.by_op["mm"] < default.by_op["mm"]
    assert plain.by_op["bmm"] < dots.by_op["bmm"] == default.by_op["bmm"]
    assert default.peak < dots.peak < plain.peak
    assert remat_bf16.by_op["mm"] == dots.by_op["mm"] < bf16.by_op["mm"]
    assert remat_bf16.peak > bf16.peak


def test_dryrun_moe_ts3_keeps_the_products_of_moe_ts2():
    """``moe_ts3`` is ``moe_ts2`` with ``remat_policy="dots"`` (reduced
    granite-moe-1b-a400m, expert parallel over a train_4k member's group):
    fewer ``mm`` FLOPs, a higher peak."""
    cfg = get_config("granite_moe_1b_a400m", reduced=True)
    ts2, ts3 = traced(cfg, "moe_ts2"), traced(cfg, "moe_ts3")
    assert ts3.by_op["mm"] < ts2.by_op["mm"] and ts3.by_op["bmm"] == ts2.by_op["bmm"]
    assert ts3.peak > ts2.peak


def test_full_width_qwen3_step_of_4096_tokens_fits_under_remat(monkeypatch):
    """``make_train_step`` of qwen3-0.6b at published widths and depth (28
    layers, ticketed embedding), one sequence of 4096 tokens, traced on
    meta tensors: under remat the predicted peak is at most 25 GiB; with
    the blocks called directly each layer's S × S probabilities stay for
    the backward and it passes 60 GiB."""
    cfg = get_config("qwen3_0_6b")
    hp = tloop.TrainHParams(total_steps=30, ticketed_embedding=True, peak_lr=1e-3, warmup=20)

    def peak():
        params = tspecs.abstract_params(cfg)
        batch = {k: torch.empty((1, 4096), dtype=torch.int32, device=tdryrun.META)
                 for k in ("tokens", "targets")}
        args = (params, tspecs.abstract_opt(params), batch)
        step = tdryrun.CellStep(tloop.make_train_step(cfg, hp), args, tdryrun._tensors(args),
                                [], 1, 0, 0)
        return tdryrun.trace(step)["memory"]["peak_bytes"]

    remat = peak()
    monkeypatch.setattr(ttf, "_remat", direct)
    plain = peak()
    assert remat <= 25 * GIB < 60 * GIB < plain, (remat / GIB, plain / GIB)


# -- a fault the families' run on the card found: the SSD decay's overflow -------------


def test_mamba2_gradients_stay_finite_where_the_intra_chunk_decay_overflows():
    """Reduced zamba2's Mamba2 block over one 32-step chunk with steep
    decays (``dt_bias`` 4: exp(cum_t − cum_u) for u > t overflows float32,
    as it does at published widths over 128-step chunks).  The reference
    masks after the exp, so 0 · inf puts NaN into its gradients; the port
    masks the exponent (ROADMAP §3 fault 12): the same outputs, every
    gradient finite."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    jcfg, tcfg = cfgs("zamba2_1_2b")
    jp = jssm.mamba2_init(jax.random.PRNGKey(4), jcfg)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 4.0))
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    x = (np.random.default_rng(4).normal(size=(2, jcfg.ssm_chunk, jcfg.d_model)) * 0.5
         ).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba2_block(p, jcfg, xx)[0] ** 2)

    jy = jssm.mamba2_block(jp, jcfg, jnp.asarray(x))[0]
    jg = jax.grad(jloss)(jp, jnp.asarray(x))
    assert not np.isfinite(np.asarray(jg["A_log"])).all()  # the reference's NaN
    tree = ttf.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    ty, _ = tssm.mamba2_block(tree, tcfg, torch.from_numpy(x))
    flat_g = iter(torch.autograd.grad(torch.sum(ty ** 2), list(ttf._leaves(tree))))
    grads = flat(ttf.tree_map(lambda _: next(flat_g), tp))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    assert all(np.isfinite(g).all() for g in grads.values())
    assert np.abs(grads["/A_log"]).max() > 0 and np.abs(grads["/dt_bias"]).max() > 0
