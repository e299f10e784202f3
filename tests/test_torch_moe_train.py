"""MoE training in repro_torch (kernel B6's plain version, the MoE layer's
gradients and ``make_train_step`` on an MoE config) against the JAX
package's, on the CPU.

B6 is ``jax.lax.ragged_dot``'s VJP: ``grouped_matmul``'s backward on CPU
tensors (autograd through the node, which calls ``grouped_matmul_backward``),
``grouped_matmul_backward`` (which takes the plain version on CPU tensors)
and ``grouped_matmul_backward_plain`` (the card kernel's oracle) are each
held to ``jax.vjp`` of ``ragged_dot`` on the same inputs, made with numpy
from a seed.  Tolerance 1e-5 · max|grad| per output: float32 matmuls that
sum in another order.  Empty groups and rows past the groups get exact
zeros.

Reduced granite-moe-1b-a400m (8 experts padded to 16, so half the groups
are always empty) in float32: ``lm_loss`` and every gradient leaf against
``jax.value_and_grad`` (loss rtol 1e-5, each leaf max|Δ| <= 1e-5 ·
max|g|), then three ``make_train_step`` steps against the reference's,
with ``tests/test_torch_train.py``'s tolerances: the parameters may move
apart by up to Σ lr where AdamW normalises a near-zero gradient entry
(each step is also compared from the same state; see the test)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

ARCH = "granite_moe_1b_a400m"
VJP_RTOL = 1e-5        # |Δ| <= VJP_RTOL · max|grad| (float32 sums reordered)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5       # max|Δ| <= GRAD_RTOL · max|g| per leaf
ROUTER_MARGIN = 1e-5   # a compared state's least top-k router gap, relative


def vjp_inputs(sizes, k, n, tail, seed):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int32)
    m = int(np.maximum(sizes, 0).sum()) + tail
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return lhs, rhs, sizes, g


def reference_vjp(lhs, rhs, sizes, g):
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


VJP_CASES = {
    # routed decode-like rows over 16 groups, the first 8 empty (granite's padding)
    "empty_groups": ([0] * 8 + [5, 9, 0, 13, 7, 1, 11, 3], 48, 40, 0),
    "rows_past_groups": ([4, 0, 17, 6], 32, 24, 9),
    "one_group_every_row": ([0, 57, 0, 0], 40, 16, 0),
    "ragged_k_n": ([3, 11, 0, 30, 2], 37, 19, 5),
}


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_grouped_matmul_backward_matches_ragged_dot_vjp(case):
    lhs, rhs, sizes, g = vjp_inputs(*VJP_CASES[case], seed=len(case))
    want_lhs, want_rhs = reference_vjp(lhs, rhs, sizes, g)
    tl, tr, ts, tg = (torch.from_numpy(x) for x in (lhs, rhs, sizes, g))
    a, b = tl.clone().requires_grad_(True), tr.clone().requires_grad_(True)
    autograd = torch.autograd.grad(gm.grouped_matmul(a, b, ts), [a, b], tg)
    for got_lhs, got_rhs in (autograd, gm.grouped_matmul_backward_plain(tl, tr, ts, tg),
                             gm.grouped_matmul_backward(tl, tr, ts, tg)):
        for got, want in ((got_lhs, want_lhs), (got_rhs, want_rhs)):
            assert got.shape == want.shape and got.dtype == torch.float32
            assert np.abs(got.numpy() - want).max() <= VJP_RTOL * np.abs(want).max()
        total = int(np.maximum(sizes, 0).sum())
        assert not got_lhs[total:].any()  # rows past the groups: exact zeros
        assert not got_rhs[torch.from_numpy(sizes <= 0)].any()  # empty groups: exact zeros


def _tf32(x):
    """TF32 rounding, half away from zero, as the kernels' split."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_drhs_precision_argument_over_a_hot_group(seed):
    """Why B6's d_rhs runs 3xTF32 with a fresh partial sum per 32-row stage
    (csrc/grouped_matmul.cu): its contraction is a group's rows, and one hot
    group of 4096 rows (K = N = 64) summed so, in 128 stages of the three
    products small·big + big·small + big·big, each stage's partial rounded
    to float32 and added to a float32 sum, lands within 1e-5 · max|out| of
    the float64 product; one TF32 product (big·big) does not."""
    rng = np.random.default_rng(seed)
    rows, k, n = 4096, 64, 64
    lhs = rng.standard_normal((rows, k)).astype(np.float32)
    g = rng.standard_normal((rows, n)).astype(np.float32)
    want = lhs.astype(np.float64).T @ g.astype(np.float64)
    scale = np.abs(want).max()
    lb, gb = _tf32(lhs), _tf32(g)
    ls, gs = _tf32(lhs - lb), _tf32(g - gb)

    def emulate(terms):
        total = np.zeros((k, n), dtype=np.float32)
        for r in range(0, rows, 32):
            part = np.zeros((k, n))
            for x, y in terms:
                part += x[r:r + 32].astype(np.float64).T @ y[r:r + 32].astype(np.float64)
            total += part.astype(np.float32)
        return total

    err3 = np.abs(emulate(((ls, gb), (lb, gs), (lb, gb))) - want).max()
    err1 = np.abs(emulate(((lb, gb),)) - want).max()
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 > 1e-5 * scale, (err1, scale)


def test_grouped_matmul_backward_need_and_checks():
    lhs, rhs, sizes, g = (torch.from_numpy(x) for x in vjp_inputs([3, 0, 5], 8, 6, 2, seed=3))
    d_lhs, d_rhs = gm.grouped_matmul_backward(lhs, rhs, sizes, g, need=(True, False))
    assert d_rhs is None and d_lhs.shape == lhs.shape
    d_lhs, d_rhs = gm.grouped_matmul_backward(lhs, rhs, sizes, g, need=(False, True))
    assert d_lhs is None and d_rhs.shape == rhs.shape
    with pytest.raises(ValueError, match="cotangent"):
        gm.grouped_matmul_backward(lhs, rhs, sizes, g[:, :5])
    with pytest.raises(ValueError, match="cotangent"):
        gm.grouped_matmul_backward(lhs, rhs, sizes, g.double())
    # only the input that requires grad gets one
    b = rhs.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gm.grouped_matmul(lhs, b, sizes), [b], g)
    assert torch.equal(got, gm.grouped_matmul_backward_plain(lhs, rhs, sizes, g)[1])


# -- the MoE model: lm_loss gradients and training steps against JAX ---------------

def cfgs(arch=ARCH):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")
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


def batch_np(jcfg, b, s, seed):
    z = np.random.default_rng(seed).zipf(1.2, size=(b, s + 1)).astype(np.int64)
    toks = ((z - 1) % jcfg.vocab_size).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_reduced_granite_is_an_moe_config_with_empty_groups():
    jcfg, tcfg = cfgs()
    assert tcfg.family == "moe" and tcfg.moe_num_experts < tcfg.moe_experts_padded
    assert all(tcfg.is_moe_layer(i) for i in range(tcfg.n_layers))


# The step test sits before the gradient test on purpose: on jax 0.9, after
# a jitted ticketed MoE lm_loss gradient in one pytest process, lowering the
# jitted reference step hoists three constants (two f32[16], one u32) into
# parameters the call does not pass ("supplied 39 buffers but compiled
# program expected 42"), even after jax.clear_caches().  No other test file
# compiles a ticketed MoE gradient before this one (tests/test_models.py's
# ticketed gradient is on a dense config), and running the eager reference
# step instead moves the loss by 1.1e-5, past LOSS_RTOL.


def to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy().copy()), tree)


def _router_margins(monkeypatch) -> list:
    """Spy on the port's ``route``: each call appends the smallest gap,
    relative, between a token's k-th and (k+1)-th router probabilities,
    computed in float64."""
    margins, route = [], tmoe.route

    def spy(p, cfg, x2d):
        probs = torch.softmax(x2d.double() @ p["router"]["w"].double(), dim=-1)
        top, _ = torch.sort(probs, dim=-1, descending=True)
        k = cfg.moe_top_k
        margins.append(float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min()))
        return route(p, cfg, x2d)

    monkeypatch.setattr(tmoe, "route", spy)
    return margins


def test_moe_train_step_matches_reference_over_three_steps(monkeypatch):
    """Each port step against the reference's step from the same state (the
    port's parameters and moments before it, carried across): metrics at
    rtol 1e-5, parameters within that step's lr (AdamW's normalised update
    turns a float32 gradient difference at a near-zero entry into up to
    lr), the median 1e-3 of it.  Free-running, the two runs then stay
    within Σ lr.  A step from the same state is what is compared, because
    after a step the two trajectories differ by up to lr and the router's
    top-k may then pick another expert for a token whose scores nearly tie,
    which moves the next loss by more than float32 rounding.  For the same
    reason each compared state must be clear of router ties: every token's
    k-th router probability stands above its (k+1)-th by at least
    ``ROUTER_MARGIN`` relative (float64).  Batches from seeds 10-12 put a
    token of the third step at 4e-8, below float32's resolution, where the
    reference's own pick changed from one process to another and moved its
    loss by 1.1e-5; seeds 20-22 clear 7e-4."""
    margins = _router_margins(monkeypatch)
    jcfg, tcfg = cfgs()
    hp = jloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=50, ticketed_embedding=True)
    thp = tloop.TrainHParams(**dataclasses.asdict(hp))
    jp, tp = ref_params(jcfg, seed=2)
    jo, to = jadamw.init(jp), tadamw.init(tp)
    base = jloop.make_train_step(jcfg, hp)

    def jstep(*args):  # jitted afresh for each call (ROADMAP §3 fault 5)
        return jax.jit(lambda *a: base(*a))(*args)

    tstep = tloop.make_train_step(tcfg, thp)
    free_p, free_o, lrs = jp, jo, []
    for i in range(3):
        bn = batch_np(jcfg, 2, 24, seed=20 + i)
        jb = {k: jnp.asarray(v) for k, v in bn.items()}
        same_p, same_o, jm = jstep(to_jax(tp), jadamw.AdamWState(*map(to_jax, to)), jb)
        free_p, free_o, _ = jstep(free_p, free_o, jb)
        margins.clear()
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in bn.items()})
        # each block's route runs twice: in the forward, then in its recompute
        # (transformer._remat), last layer first, on the same inputs
        n = tcfg.n_layers
        assert len(margins) == 2 * n and min(margins) >= ROUTER_MARGIN, margins
        assert margins[n:] == margins[:n][::-1], margins
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        lrs.append(float(jm["lr"]))
        assert int(to.step) == int(same_o.step) == i + 1
        fj, ft = flat(same_p), flat(tp)
        diffs = np.concatenate([np.abs(ft[k] - fj[k]).ravel() for k in fj])
        assert diffs.max() <= lrs[-1] + 1e-7, (i, diffs.max())
        assert np.median(diffs) <= 1e-3 * lrs[-1] + 1e-9, (i, np.median(diffs))
    fj, ft = flat(free_p), flat(tp)
    diffs = np.concatenate([np.abs(ft[k] - fj[k]).ravel() for k in fj])
    assert diffs.max() <= sum(lrs), diffs.max()
    assert np.median(diffs) <= 1e-3 * sum(lrs), np.median(diffs)


@pytest.mark.parametrize("arch,ticketed", [
    (ARCH, True), (ARCH, False),
    ("qwen2_moe_a2_7b", True),  # a shared expert and its gate beside the routed ones
])
def test_moe_lm_loss_and_every_gradient_leaf_match_reference(arch, ticketed):
    jcfg, tcfg = cfgs(arch)
    jp, tp = ref_params(jcfg, seed=1)
    bn = batch_np(jcfg, 2, 24, seed=5)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb, ticketed_embedding=ticketed), has_aux=True))(jp)
    tree = ttf.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tl, tm = ttf.lm_loss(tree, tcfg, {k: torch.from_numpy(v) for k, v in bn.items()},
                         ticketed_embedding=ticketed)
    flat_g = iter(torch.autograd.grad(tl, list(ttf._leaves(tree))))
    tg = ttf.tree_map(lambda _: next(flat_g), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["nll"].detach()), float(jm["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]), rtol=LOSS_RTOL)
    assert float(jm["aux"]) > 0
    fj, ft = flat(jg), flat(tg)
    assert set(fj) == set(ft)
    # the gradient reaches the router (top-k weights and the aux loss's p_e),
    # every expert tensor and the shared expert; padded experts get none
    assert any("router" in k for k in fj) and any("w_down" in k for k in fj)
    assert bool(tcfg.moe_shared_d_ff) == any("shared" in k for k in fj)
    for k in fj:
        scale = np.abs(fj[k]).max()
        assert np.abs(ft[k] - fj[k]).max() <= GRAD_RTOL * scale, k
        if "router" in k or "w_" in k or "shared" in k:
            assert scale > 0, k
    for name in ("w_gate", "w_up", "w_down"):
        w = [v for k, v in ft.items() if k.endswith(name)][0]
        assert not w[:, tcfg.moe_num_experts:].any()  # padded experts: never routed to
