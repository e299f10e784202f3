"""The LM stack of repro_torch (``models/``, ``configs/``) against the JAX
package, on the CPU.

Parameters come from the reference's ``init_params`` / ``*_init`` and are
carried across with ``params_from_numpy``; inputs are made with numpy from
a seed and handed to both.  Tolerances: layers at float32 atol 1e-5;
attention and MoE at float32 rtol 1e-4 (einsums and softmax sum in another
order than XLA's); whole-model logits at float32 max|Δ| / max|logit| <
1e-4, and the one bfloat16 case at the reference's own 0.05 (bf16 rounds
at other places in the two frameworks).  The router's expert ids and its
GROUP BY COUNT histogram are exact.  On the CPU every kernel wrapper runs
its plain version: the grouped matmul's (a loop of float32 ``torch.matmul``
over groups) is held to ``jax.lax.ragged_dot`` at rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

B, S = 2, 32
CPU = "cpu"


def f32(arch):
    return dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")


def tcfg_of(jcfg):
    """The port's config of the same fields as a reference config."""
    return TModelConfig(**dataclasses.asdict(jcfg))


def carry(tree):
    return ttf.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def t(x):
    return torch.from_numpy(np.asarray(x))


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def batch_of(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.1
    if cfg.encoder_layers:
        batch["encoder_frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32) * 0.1
    return batch


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_reference_field_for_field(arch):
    for reduced in (False, True):
        j = jconfigs.get_config(arch, reduced=reduced)
        p = tconfigs.get_config(arch.replace("_", "-"), reduced=reduced)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.block_kinds() == j.block_kinds()
        assert [p.is_moe_layer(i) for i in range(p.n_layers)] == \
            [j.is_moe_layer(i) for i in range(j.n_layers)]
        assert (p.moe_experts_padded, p.attn_dim, p.kv_dim) == \
            (j.moe_experts_padded, j.attn_dim, j.kv_dim)
        assert [c.name for c in tconfigs.applicable_shapes(p)] == \
            [c.name for c in jconfigs.applicable_shapes(j)]


def test_registry_and_shapes_equal_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.all_configs().items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.all_configs().items()}
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(tconfigs.get_config("granite_moe_1b_a400m").reduced(n_layers=3)) == \
        dataclasses.asdict(jconfigs.get_config("granite_moe_1b_a400m").reduced(n_layers=3))


# -- layers (float32, atol 1e-5) --------------------------------------------------


def test_norms():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    np.testing.assert_allclose(tlayers.rmsnorm(carry(p), t(x)).numpy(),
                               np.asarray(jlayers.rmsnorm(p, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(tlayers.layernorm(carry(p), t(x)).numpy(),
                               np.asarray(jlayers.layernorm(p, jnp.asarray(x))), atol=1e-5)
    for kind in ("rmsnorm", "layernorm"):
        assert set(tlayers.norm_init(kind, 64)) == set(jlayers.norm_init(kind, 64))


def test_dense_and_int8_dense():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 48)).astype(np.float32)
    p = jlayers.dense_init(jax.random.PRNGKey(0), 48, 40, bias=True)
    p = {"w": p["w"], "b": jnp.asarray(rng.normal(size=(40,)).astype(np.float32))}
    np.testing.assert_allclose(tlayers.dense(carry(p), t(x)).numpy(),
                               np.asarray(jlayers.dense(p, jnp.asarray(x))), atol=1e-5)
    # the reference's int8 tree, carried; and the port's own quantization
    jq = jlayers.quantize_dense_params({"a": p, "stack": {"w": jnp.stack([p["w"]] * 3)}})
    tq = tlayers.quantize_dense_params(carry({"a": p, "stack": {"w": jnp.stack([p["w"]] * 3)}}))
    for key in ("a", "stack"):
        assert set(tq[key]) == set(jq[key])
        np.testing.assert_array_equal(tq[key]["w_q8"].numpy(), np.asarray(jq[key]["w_q8"]))
        np.testing.assert_allclose(tq[key]["w_scale"].numpy(), np.asarray(jq[key]["w_scale"]),
                                   rtol=1e-6)
    assert tq["a"]["w_q8"].dtype == torch.int8
    np.testing.assert_allclose(tlayers.dense(carry(jq["a"]), t(x)).numpy(),
                               np.asarray(jlayers.dense(jq["a"], jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope(fraction):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = (np.arange(9)[None, :] + 5).astype(np.int32)
    got = tlayers.apply_rope(t(x), t(pos), 10_000.0, fraction)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_softcap():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    np.testing.assert_allclose(tlayers.softcap(t(x), 30.0).numpy(),
                               np.asarray(jlayers.softcap(jnp.asarray(x), 30.0)), atol=1e-5)
    assert torch.equal(tlayers.softcap(t(x), None), t(x))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 64)).astype(np.float32)
    p = jlayers.mlp_init(jax.random.PRNGKey(1), 64, 96, kind)
    got = tlayers.mlp(carry(p), t(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.mlp(p, jnp.asarray(x), kind)),
                               atol=1e-5)


def test_embed_and_ticketed_embed_forward():
    rng = np.random.default_rng(5)
    p = jlayers.embedding_init(jax.random.PRNGKey(2), 300, 32)
    ids = rng.integers(0, 300, (4, 11)).astype(np.int32)
    want = np.asarray(jlayers.embed(p, jnp.asarray(ids), jnp.float32))
    np.testing.assert_allclose(tlayers.embed(carry(p), t(ids), torch.float32).numpy(), want)
    got = tlayers.ticketed_embed(carry(p)["table"], t(ids), 44, 128)
    np.testing.assert_allclose(got.numpy(), want)


def test_ticketed_embed_backward_raises_until_the_training_slice():
    """The training slice has landed: the backward no longer raises, and
    gives the dense gather's gradient (``tests/test_torch_train.py`` holds
    it to JAX's)."""
    table = torch.randn(50, 8, requires_grad=True)
    out = tlayers.ticketed_embed(table, torch.tensor([[1, 2, 2]]), 3, 8)
    out.sum().backward()
    want = torch.zeros(50, 8)
    want[1], want[2] = 1.0, 2.0
    assert torch.equal(table.grad, want)


# -- attention (float32, rtol 1e-4) ------------------------------------------------

ATTN_CASES = {
    # name: (arch, kwargs)
    "train": ("qwen3_0_6b", {}),
    "window": ("gemma2_2b", {"window": 8}),
    "global": ("gemma2_2b", {"window": -1}),
    "bias": ("qwen2_5_14b", {}),
    "stablelm_partial_rope": ("stablelm_1_6b", {}),
    "noncausal": ("qwen3_0_6b", {"causal": False}),
}


def _attn_params(cfg, seed=0):
    p = jattn.attn_init(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:  # non-zero biases, so the bias path is exercised
        rng = np.random.default_rng(seed)
        for k in ("wq", "wk", "wv"):
            p[k]["b"] = jnp.asarray(rng.normal(size=p[k]["b"].shape).astype(np.float32) * 0.1)
    if cfg.qk_norm:
        rng = np.random.default_rng(seed + 1)
        for k in ("q_norm", "k_norm"):
            p[k]["scale"] = jnp.asarray(1 + 0.1 * rng.normal(size=p[k]["scale"].shape).astype(np.float32))
    return p


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_multihead_attention(case):
    arch, kw = ATTN_CASES[case]
    cfg = f32(arch)
    p = _attn_params(cfg)
    x = np.random.default_rng(6).normal(size=(B, 20, cfg.d_model)).astype(np.float32)
    want, _ = jattn.multihead_attention(p, cfg, jnp.asarray(x), **kw)
    got, _ = tattn.multihead_attention(carry(p), tcfg_of(cfg), t(x), **kw)
    assert rel_err(got.numpy(), want) < 1e-4


def test_cross_attention():
    cfg = f32("seamless_m4t_large_v2")
    p = _attn_params(cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 9, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, 13, cfg.d_model)).astype(np.float32)
    want, _ = jattn.multihead_attention(p, cfg, jnp.asarray(x), memory=jnp.asarray(mem), causal=False)
    got, _ = tattn.multihead_attention(carry(p), tcfg_of(cfg), t(x), memory=t(mem), causal=False)
    assert rel_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("arch,window", [("gemma2_2b", 6), ("qwen3_0_6b", None)])
def test_attention_decode_with_cache(arch, window):
    """A cached prefill of 5 tokens, then 6 one-token steps, appended in
    place; gemma2 adds softcap and a window, qwen3 qk-norm."""
    cfg = f32(arch)
    p = _attn_params(cfg)
    tc, tp = tcfg_of(cfg), carry(p)
    xs = np.random.default_rng(8).normal(size=(B, 11, cfg.d_model)).astype(np.float32)
    jc = jattn.make_cache(cfg, B, 16, jnp.float32)
    tcache = tattn.make_cache(tc, B, 16, torch.float32, CPU)
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, 11)]:
        want, jc = jattn.multihead_attention(p, cfg, jnp.asarray(xs[:, lo:hi]), window=window, cache=jc)
        got, tcache = tattn.multihead_attention(tp, tc, t(xs[:, lo:hi]), window=window, cache=tcache)
        assert rel_err(got.numpy(), want) < 1e-4
        assert int(tcache.length) == int(jc.length) == hi
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("prefix_dtype", ["bfloat16", "int8"])
def test_twobuf_attention(prefix_dtype):
    cfg = f32("gemma2_2b")
    p = _attn_params(cfg, seed=3)
    tc, tp = tcfg_of(cfg), carry(p)
    rng = np.random.default_rng(9)
    kvh, hd, sp, st = cfg.n_kv_heads, cfg.head_dim, 12, 6
    if prefix_dtype == "int8":
        pk = rng.integers(-127, 128, (B, sp, kvh, hd)).astype(np.int8)
        pv = rng.integers(-127, 128, (B, sp, kvh, hd)).astype(np.int8)
        jpre = jattn.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(9, jnp.int32))
        tpre = tattn.KVCache(t(pk), t(pv), torch.tensor(9, dtype=torch.int32))
    else:
        pk = rng.normal(size=(B, sp, kvh, hd)).astype(np.float32)
        pv = rng.normal(size=(B, sp, kvh, hd)).astype(np.float32)
        jpre = jattn.KVCache(jnp.asarray(pk, jnp.bfloat16), jnp.asarray(pv, jnp.bfloat16),
                             jnp.asarray(9, jnp.int32))
        tpre = tattn.KVCache(t(pk).bfloat16(), t(pv).bfloat16(), torch.tensor(9, dtype=torch.int32))
    jtail = jattn.make_cache(cfg, B, st, jnp.float32)
    ttail = tattn.make_cache(tc, B, st, torch.float32, CPU)
    for step in range(4):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        for window in (None, 5):
            want, jt2 = jattn.twobuf_attention(p, cfg, jnp.asarray(x), jpre, jtail, window=window)
            got, tt2 = tattn.twobuf_attention(tp, tc, t(x), tpre, ttail, window=window)
            assert rel_err(got.numpy(), want) < 1e-4, (step, window)
        jtail, ttail = jt2, tt2
    assert int(ttail.length) == int(jtail.length) == 4


# -- MoE -----------------------------------------------------------------------------


def test_route_ids_histogram_and_weights():
    cfg = f32("granite_moe_1b_a400m")
    p = jmoe.moe_init(jax.random.PRNGKey(3), cfg)
    x = np.random.default_rng(10).normal(size=(24, cfg.d_model)).astype(np.float32)
    want = jmoe.route(p, cfg, jnp.asarray(x))
    got = tmoe.route(carry(p), tcfg_of(cfg), t(x))
    np.testing.assert_array_equal(got.experts.numpy(), np.asarray(want.experts))
    np.testing.assert_array_equal(got.histogram.numpy(), np.asarray(want.histogram))
    assert got.histogram.shape == (cfg.moe_experts_padded,)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-6)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=1e-5)


@pytest.mark.parametrize("sizes,m", [
    ([5, 0, 12, 0, 3, 10], 40),   # empty groups and 10 rows past Σ sizes
    ([0, 7, 0, 0, 9, 24], 40),    # Σ sizes = M, an empty first group
    ([0, 0, 0, 0, 0, 0], 8),      # no rows routed: all zeros
])
def test_grouped_matmul_plain_equals_ragged_dot(sizes, m):
    rng = np.random.default_rng(11)
    lhs = rng.normal(size=(m, 24)).astype(np.float32)
    rhs = rng.normal(size=(6, 24, 20)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs)))
    for fn in (tgm.grouped_matmul, tgm.grouped_matmul_plain):  # the wrapper on the CPU: plain
        got = fn(t(lhs), t(rhs), t(gs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[sum(sizes):].any()
    assert tgm.grouped_matmul.launches == 0  # no launch off the card


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits, half away from zero, as
    ``cvt.rna.tf32.f32``), kept in float32."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("k,n", [(1024, 512), (512, 1024)])  # granite decode: gate / up, down
def test_grouped_matmul_precision_argument(k, n):
    """Why B3 runs 3xTF32 and not TF32 (csrc/grouped_matmul.cu): at the
    decode widths (64 rows over 32 experts), the three products big·big +
    big·small + small·big of each operand split x = tf32(x) + tf32(x -
    tf32(x)), summed exactly, stay within GMM_RTOL = 1e-5 of
    max|grouped_matmul_plain|, and one TF32 product does not.  The plain
    version itself agrees with ``jax.lax.ragged_dot`` at these widths."""
    rng = np.random.default_rng(k + n)
    ids = np.argsort(rng.normal(size=(8, 32)), axis=1)[:, :8].reshape(-1)  # top-8, distinct
    gs = np.bincount(ids, minlength=32).astype(np.int32)
    lhs = rng.normal(size=(64, k)).astype(np.float32)
    rhs = (rng.normal(size=(32, k, n)) * k ** -0.5).astype(np.float32)
    plain = tgm.grouped_matmul_plain(t(lhs), t(rhs), t(gs)).numpy()
    scale = np.abs(plain).max()

    def emulate(terms):
        out, start = np.zeros((64, n)), 0
        for g, size in enumerate(gs):
            a, w = lhs[start:start + size], rhs[g]
            ab, wb = _tf32(a), _tf32(w)
            asm, wsm = _tf32(a - ab), _tf32(w - wb)
            prods = {"bb": (ab, wb), "bs": (ab, wsm), "sb": (asm, wb)}
            for key in terms:
                x, y = prods[key]
                out[start:start + size] += x.astype(np.float64) @ y.astype(np.float64)
            start += size
        return out

    err3 = np.abs(emulate(("sb", "bs", "bb")) - plain).max()
    err1 = np.abs(emulate(("bb",)) - plain).max()
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 > 1e-5 * scale, (err1, scale)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs)))
    assert np.abs(plain - want).max() <= 1e-5 * scale


def test_grouped_matmul_rejects_what_the_kernel_does_not_take():
    lhs, rhs, gs = torch.zeros(4, 3), torch.zeros(2, 3, 5), torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        tgm.grouped_matmul(lhs.double(), rhs, gs)
    with pytest.raises(ValueError, match="int32"):
        tgm.grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="agree"):
        tgm.grouped_matmul(lhs, torch.zeros(3, 3, 5), gs)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen2_moe_a2_7b"])
def test_moe_mlp_dense(arch):
    cfg = f32(arch)
    p = jmoe.moe_init(jax.random.PRNGKey(4), cfg)
    if "shared_gate" in p:  # a gate that is not ~0.5 everywhere
        p["shared_gate"]["w"] = p["shared_gate"]["w"] * 50
    x = np.random.default_rng(12).normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_mlp_dense(p, cfg, jnp.asarray(x))
    got, gaux = tmoe.moe_mlp_dense(carry(p), tcfg_of(cfg), t(x))
    assert rel_err(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


# -- whole model ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_logits_float32(arch):
    cfg = f32(arch)
    params = jtf.init_params(jax.random.PRNGKey(1), cfg)
    batch = batch_of(cfg, np.random.default_rng(13))
    want = jax.jit(lambda p, b: jtf.forward(p, cfg, b, ticketed_embedding=False))(
        params, jax.tree.map(jnp.asarray, batch))
    got = ttf.forward(carry(params), tcfg_of(cfg), {k: t(v) for k, v in batch.items()},
                      ticketed_embedding=arch == "qwen3_0_6b")
    assert got.logits.shape == (B, S, cfg.vocab_size)
    assert rel_err(got.logits.numpy(), want.logits) < 1e-4
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=1e-4, atol=1e-7)
    if arch == "qwen3_0_6b":  # lm_loss, forward only
        batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
        batch["targets"][:, -1] = -1
        jl, _ = jtf.lm_loss(params, cfg, jax.tree.map(jnp.asarray, batch), ticketed_embedding=False)
        tl, _ = ttf.lm_loss(carry(params), tcfg_of(cfg), {k: t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_forward_bfloat16_at_the_reference_tolerance():
    jcfg = jconfigs.get_config("granite_moe_1b_a400m", reduced=True)
    assert jcfg.dtype == "bfloat16"
    params = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tokens = np.random.default_rng(14).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)}, ticketed_embedding=False)
    got = ttf.forward(carry(params), tcfg_of(jcfg), {"tokens": t(tokens)})
    assert rel_err(got.logits.numpy(), want.logits) < 0.05


@pytest.mark.parametrize("arch", ["gemma2_2b", "granite_moe_1b_a400m", "zamba2_1_2b", "rwkv6_1_6b"])
def test_decode_step_equals_reference(arch):
    cfg = f32(arch)
    tc = tcfg_of(cfg)
    params = jtf.init_params(jax.random.PRNGKey(2), cfg)
    tp = carry(params)
    steps = 12
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jstep = jax.jit(lambda p, tok, c: jtf.decode_step(p, cfg, tok, c))
    jc = jtf.init_caches(cfg, B, steps + 4, jnp.float32)
    tcache = ttf.init_caches(tc, B, steps + 4, torch.float32, device=CPU)
    for i in range(steps):
        want, jc = jstep(params, jnp.asarray(tokens[:, i:i + 1]), jc)
        got, tcache = ttf.decode_step(tp, tc, t(tokens[:, i:i + 1]), tcache)
        assert rel_err(got.numpy(), want) < 1e-4, i


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "zamba2_1_2b", "rwkv6_1_6b"])
def test_cached_prefill_last_only_equals_reference(arch):
    """A prefill THROUGH the cache (attention appends in place, SSM / RWKV
    run the chunked path seeded from the cache), logits of the last
    position only, then one decode step."""
    cfg = f32(arch)
    tc = tcfg_of(cfg)
    params = jtf.init_params(jax.random.PRNGKey(3), cfg)
    tp = carry(params)
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jc = jtf.init_caches(cfg, B, S + 8, jnp.float32)
    tcache = ttf.init_caches(tc, B, S + 8, torch.float32, device=CPU)
    want, jc = jtf.decode_step(params, cfg, jnp.asarray(tokens[:, :S]), jc, last_only=True)
    got, tcache = ttf.decode_step(tp, tc, t(tokens[:, :S]), tcache, last_only=True)
    assert got.shape == (B, 1, cfg.vocab_size)
    assert rel_err(got.numpy(), want) < 1e-4
    want, _ = jtf.decode_step(params, cfg, jnp.asarray(tokens[:, S:]), jc)
    got, _ = ttf.decode_step(tp, tc, t(tokens[:, S:]), tcache)
    assert rel_err(got.numpy(), want) < 1e-4


def test_decode_step_with_memory_and_frontend_embeds():
    """Enc-dec cross-attention memory in the cached step, and a VLM
    prefill whose first F positions are frontend embeddings."""
    for arch in ("seamless_m4t_large_v2", "internvl2_2b"):
        cfg = f32(arch)
        tc = tcfg_of(cfg)
        params = jtf.init_params(jax.random.PRNGKey(4), cfg)
        tp = carry(params)
        rng = np.random.default_rng(17)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        kw_j, kw_t = {}, {}
        if cfg.encoder_layers:
            mem = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
            kw_j["memory"], kw_t["memory"] = jnp.asarray(mem), t(mem)
        else:
            fe = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            kw_j["frontend_embeds"], kw_t["frontend_embeds"] = jnp.asarray(fe), t(fe)
        jc = jtf.init_caches(cfg, B, S + 4, jnp.float32)
        tcache = ttf.init_caches(tc, B, S + 4, torch.float32, device=CPU)
        want, _ = jtf.decode_step(params, cfg, jnp.asarray(tokens), jc, **kw_j)
        got, _ = ttf.decode_step(tp, tc, t(tokens), tcache, **kw_t)
        assert rel_err(got.numpy(), want) < 1e-4, arch


def test_twobuf_decode_step_equals_reference():
    cfg = f32("qwen3_0_6b")
    tc = tcfg_of(cfg)
    params = jtf.init_params(jax.random.PRNGKey(5), cfg)
    tp = carry(params)
    jpre, jtail = jtf.init_twobuf_caches(cfg, B, 8, 4, jnp.float32)
    tpre, ttail = ttf.init_twobuf_caches(tc, B, 8, 4, torch.float32, device=CPU)
    tokens = np.random.default_rng(18).integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    for i in range(3):
        want, jtail = jtf.decode_step_twobuf(params, cfg, jnp.asarray(tokens[:, i:i + 1]), jpre, jtail)
        got, ttail = ttf.decode_step_twobuf(tp, tc, t(tokens[:, i:i + 1]), tpre, ttail)
        assert rel_err(got.numpy(), want) < 1e-4


def test_init_params_tree_equals_reference_and_round_trips():
    for arch in ("granite_moe_1b_a400m", "zamba2_1_2b", "seamless_m4t_large_v2", "rwkv6_1_6b"):
        cfg = f32(arch)
        jp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg))
        tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg_of(cfg), device=CPU)
        jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        tflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(ttf.params_to_numpy(tp))[0]}
        assert {k: (v.shape, v.dtype) for k, v in tflat.items()} == \
            {k: (v.shape, v.dtype) for k, v in jflat.items()}, arch
        back = ttf.params_to_numpy(ttf.params_from_numpy(jp, CPU))
        jax.tree.map(np.testing.assert_array_equal, back, jp)
    q = jlayers.quantize_dense_params(jtf.init_params(jax.random.PRNGKey(0), f32("qwen3_0_6b")))
    back = ttf.params_to_numpy(ttf.params_from_numpy(q, CPU))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, q))


def test_int8_params_forward_equals_reference():
    cfg = f32("qwen3_0_6b")
    q = jlayers.quantize_dense_params(jtf.init_params(jax.random.PRNGKey(6), cfg))
    tokens = np.random.default_rng(19).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = jtf.forward(q, cfg, {"tokens": jnp.asarray(tokens)}, ticketed_embedding=False)
    got = ttf.forward(carry(q), tcfg_of(cfg), {"tokens": t(tokens)}, ticketed_embedding=False)
    assert rel_err(got.logits.numpy(), want.logits) < 1e-4


def test_layer_windows_and_padded_vocab():
    for arch in jconfigs.ARCH_IDS:
        cfg = jconfigs.get_config(arch)
        w = jtf.layer_windows(cfg)
        got = ttf.layer_windows(tcfg_of(cfg))
        assert (got is None) == (w is None)
        if w is not None:
            assert got == np.asarray(w).tolist()
        assert ttf.padded_vocab(cfg.vocab_size) == jtf.padded_vocab(cfg.vocab_size)


def test_expert_parallel_moe_raises_until_the_placement_slice():
    """``moe_impl="ep"`` runs over a (data 1, model 4) mesh of CPU members
    (with ample capacity, the dense logits) and raises where the padded
    experts do not split over the model axis (tests/test_torch_ep.py holds
    it to the reference's EP)."""
    from repro_torch.parallel import sharding

    cfg = f32("granite_moe_1b_a400m")
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg_of(cfg), device=CPU)
    batch = {"tokens": torch.arange(8, dtype=torch.int32).reshape(2, 4)}
    dense = ttf.forward(tp, tcfg_of(cfg), batch, ticketed_embedding=False)
    for shape, ok in (((1, 4), True), ((1, 3), False)):
        with sharding.virtual_devices(shape[0] * shape[1], CPU) as members:
            mesh = sharding.make_mesh(shape, ("data", "model"), devices=members)
        info = {"mesh": mesh, "dp": ("data",), "capacity_per_expert": 64}
        if ok:
            ep = ttf.forward(tp, tcfg_of(cfg), batch, ticketed_embedding=False, moe_impl="ep",
                             ep_info=info)
            assert rel_err(ep.logits.numpy(), dense.logits.numpy()) < 1e-5
        else:
            with pytest.raises(ValueError, match="do not split over a model axis of 3"):
                ttf.forward(tp, tcfg_of(cfg), batch, ticketed_embedding=False, moe_impl="ep",
                            ep_info=info)
    sharding.reset_virtual_devices()


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(torch.Generator(), tconfigs.get_config("qwen3_0_6b", reduced=True))


def test_lm_params_through_both_checkpoint_managers(tmp_path):
    """The port's parameter tree goes through the port's
    ``CheckpointManager`` (its a/b/0 flattener) as it is: the port saves,
    the reference restores into its own tree, and back."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint.manager import CheckpointManager as TManager

    cfg = f32("granite_moe_1b_a400m")
    jp = jtf.init_params(jax.random.PRNGKey(7), cfg)
    tp = carry(jp)
    TManager(str(tmp_path / "port"), async_save=False).save(3, tp)
    restored, step = JManager(str(tmp_path / "port"), async_save=False).restore_latest(jp)
    assert step == 3
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, restored),
                 jax.tree.map(np.asarray, jp))
    JManager(str(tmp_path / "ref"), async_save=False).save(5, jp)
    back, step = TManager(str(tmp_path / "ref"), async_save=False).restore_latest(tp, device="cpu")
    assert step == 5
    jax.tree.map(np.testing.assert_array_equal, ttf.params_to_numpy(back), ttf.params_to_numpy(tp))
