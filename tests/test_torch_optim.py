"""The optimizer pieces of repro_torch (``optim/``: schedules, clipping,
AdamW, int8 block quantization) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
rtol 1e-6 (and atol 1e-7 for values near 0), the float32 rounding of the
same elementwise formulas evaluated by two libraries; int8 codes exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch import optim as toptim
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import clip as tclip
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedules as tsched

RTOL, ATOL = 1e-6, 1e-7


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL, atol=ATOL)


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"table": (scale * rng.standard_normal((17, 8))).astype(np.float32)},
        "layers": {"w": (scale * rng.standard_normal((2, 8, 5))).astype(np.float32),
                   "scale": (scale * rng.standard_normal((2, 5))).astype(np.float32)},
        "final_norm": {"scale": (scale * rng.standard_normal((8,))).astype(np.float32)},
    }


def to_torch(t):
    return {k: to_torch(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(t.copy())


def to_jax(t):
    return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)


def pairs(port, ref):
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            yield from pairs(port[k], ref[k])
    else:
        yield port, ref


@pytest.mark.parametrize("step", [0, 1, 7, 19, 20, 21, 500, 999, 1000, 5000])
def test_warmup_cosine_and_constant_match_reference(step):
    kw = dict(peak_lr=1e-3, warmup=20, total=1000)
    got = tsched.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    want = jsched.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    close(got, want)
    close(tsched.warmup_cosine(torch.tensor(step, dtype=torch.int32), peak_lr=3e-4, warmup=0,
                               total=10, floor=0.0),
          jsched.warmup_cosine(jnp.asarray(step, jnp.int32), peak_lr=3e-4, warmup=0, total=10,
                               floor=0.0))
    c = tsched.constant(torch.tensor(step, dtype=torch.int32), lr=2.5e-4)
    assert c.dtype == torch.float32 and c.shape == ()
    close(c, jsched.constant(jnp.asarray(step, jnp.int32), lr=2.5e-4))


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0), (3.0, 0.5)])
def test_global_norm_and_clip_match_reference(scale, max_norm):
    g = tree(1, scale)
    close(tclip.global_norm(to_torch(g)), jclip.global_norm(to_jax(g)))
    tg, tn = tclip.clip_by_global_norm(to_torch(g), max_norm)
    jg, jn = jclip.clip_by_global_norm(to_jax(g), max_norm)
    close(tn, jn)
    for a, b in pairs(tg, jg):
        assert a.dtype == torch.float32
        close(a, b)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr_tensor", [False, True])
def test_adamw_matches_reference_over_steps(weight_decay, lr_tensor):
    p0 = tree(2)
    tp, jp = to_torch(p0), to_jax(p0)
    ts, js = tadamw.init(tp), jadamw.init(jp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for a, b in pairs(ts.m, js.m):
        assert a.dtype == torch.float32 and not a.any()
    for i in range(5):
        g = tree(10 + i, scale=0.5)
        lr = 1e-2 * (i + 1)
        t_lr = torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr
        ts, tp = tadamw.update(ts, to_torch(g), tp, lr=t_lr, weight_decay=weight_decay)
        js, jp = jadamw.update(js, to_jax(g), jp, lr=lr, weight_decay=weight_decay)
        assert int(ts.step) == int(js.step) == i + 1
        for a, b in pairs(tp, jp):
            close(a, b)
        for a, b in pairs(ts.m, js.m):
            close(a, b)
        for a, b in pairs(ts.v, js.v):
            close(a, b)


def test_adamw_updates_in_place_and_keeps_bf16_leaves():
    p = {"w": torch.ones(4), "b": torch.ones(3, dtype=torch.bfloat16)}
    w, b = p["w"], p["b"]
    s = tadamw.init(p)
    step = s.step
    s2, p2 = tadamw.update(s, {"w": torch.ones(4), "b": torch.ones(3, dtype=torch.bfloat16)},
                           p, lr=0.1)
    assert p2["w"] is w and p2["b"] is b and s2.step is step and int(step) == 1
    assert p2["b"].dtype == torch.bfloat16 and s2.m["b"].dtype == torch.float32
    assert float(w[0]) < 1.0


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_quantize_dequantize_match_reference(n):
    x = (np.random.default_rng(n).standard_normal((n,)) * 3).astype(np.float32)
    x[::7] = 0.0
    tq, ts, tn = tcomp.quantize(torch.from_numpy(x))
    jq, js, jn = jcomp.quantize(jnp.asarray(x))
    assert tn == jn == n and tcomp.BLOCK == jcomp.BLOCK == 256
    assert tq.dtype == torch.int8 and tq.shape == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    close(ts, js)
    got = tcomp.dequantize(tq, ts, tn, (n,), torch.float32)
    want = jcomp.dequantize(jq, js, jn, (n,), jnp.float32)
    close(got, want)


@pytest.mark.parametrize("participants,shape", [
    (2, (1000,)),      # a length off the 256-value block
    (2, (256,)),
    (4, (1000,)),
    (4, (3, 7, 50)),   # 1050 values in three dims
    (1, (300,)),       # one pod: quantization alone, as the reference's
])
def test_compressed_psum_matches_reference_under_vmap(participants, shape):
    """The port's compressed_psum over per-member tensors against the
    reference's under ``jax.vmap(..., axis_name="pod")`` over the stacked
    participants: the int8 codes and their int32 sum are exact, the mean
    scale and the dequantized sum float32 (rtol 1e-6)."""
    import jax

    from repro_torch.parallel import sharding

    rng = np.random.default_rng(participants * 1000 + int(np.prod(shape)))
    xs = (rng.standard_normal((participants, *shape)) * rng.uniform(0.1, 5, participants)
          .reshape(-1, *[1] * len(shape))).astype(np.float32)
    xs[..., ::11] = 0.0
    want = jax.vmap(lambda x: jcomp.compressed_psum(x, "pod"), axis_name="pod")(jnp.asarray(xs))
    with sharding.virtual_devices(participants, "cpu") as members:
        got = tcomp.compressed_psum([torch.from_numpy(x) for x in xs], members[0])
    assert got.shape == shape and got.dtype == torch.float32
    for row in np.asarray(want):  # every participant holds the same sum
        close(got, row)


def test_optim_package_exports():
    for name in ("AdamWState", "adamw", "clip_by_global_norm", "global_norm", "quantize",
                 "dequantize", "compressed_psum", "warmup_cosine", "constant", "BLOCK"):
        assert name in toptim.__all__ and hasattr(toptim, name)
    assert toptim.AdamWState._fields == jadamw.AdamWState._fields
