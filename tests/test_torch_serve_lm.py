"""The LM serving loop of repro_torch (``serve/engine.py``: ``ServeLoop``,
``Request``, ``make_serve_step``) against the JAX package's, on the CPU.

Both loops serve the same requests with the reference's parameters
(carried across with ``params_from_numpy``) at float32 on a one-member
mesh (the port's on the CPU); greedy decoding must give the same tokens,
token for token, ragged prompt lengths and budgets included.  The port's
loop rides its own ``serve.scheduler.Scheduler``, as the reference's rides
its own."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.parallel import sharding
from repro_torch.serve import engine as tengine

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)


def cpu_mesh(n=1):
    with sharding.virtual_devices(n, "cpu") as members:
        return sharding.make_mesh((n, 1), ("data", "model"), devices=members)


def jax_mesh():
    # Auto axes, as the reference's meshes were built (``jax.make_mesh`` now
    # defaults to Explicit axes, which its cache append does not satisfy)
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def both(arch, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), dtype="float32")
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_1b_a400m"])
def test_serve_loop_tokens_equal_reference(arch):
    jcfg, tcfg, jp, tp = both(arch)
    jloop = jengine.ServeLoop(jax_mesh(), jcfg, jp, slots=4, max_len=48)
    tloop = tengine.ServeLoop(cpu_mesh(), tcfg, tp, slots=4, max_len=48)
    # two batches through each loop: ragged prompts and budgets, an empty
    # slot in the second; each batch starts from fresh caches
    for lengths, budgets, seed in (([3, 7, 1, 5], [6, 4, 9, 2], 1), ([4, 2, 6], [5, 5, 3], 2)):
        ps = prompts(jcfg, lengths, seed)
        jreqs = [jengine.Request(uid=i, prompt=jnp.asarray(p), max_new=m)
                 for i, (p, m) in enumerate(zip(ps, budgets))]
        treqs = [tengine.Request(uid=i, prompt=torch.from_numpy(p) if i % 2 else p.tolist(),
                                 max_new=m) for i, (p, m) in enumerate(zip(ps, budgets))]
        jout = jloop.run_batch(jreqs)
        tout = tloop.run_batch(treqs)
        assert [r.generated for r in tout] == [r.generated for r in jout]
        assert all(r.done and len(r.generated) == m for r, m in zip(tout, budgets))
        assert all(0 <= tok < jcfg.vocab_size for r in tout for tok in r.generated)
    assert tloop.caches.k.device.type == "cpu"


def test_serve_step_is_greedy_over_decode_step():
    _, tcfg, _, tp = both("qwen3_0_6b", seed=3)
    step = tengine.make_serve_step(tcfg)
    caches = ttf.init_caches(tcfg, 2, 8, torch.float32, device="cpu")
    tokens = torch.tensor([[3], [11]], dtype=torch.int32)
    nxt, logits, caches = step(tp, tokens, caches)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0], torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
    assert caches.length.tolist() == [1] * tcfg.n_layers


def test_serve_loop_on_more_than_one_member_raises():
    """A loop over two data members serves the one-member loop's tokens
    (tests/test_torch_serve_members.py holds it to the reference's loop on
    the same meshes); more requests than slots raise ``ValueError`` on
    either."""
    _, tcfg, _, tp = both("qwen3_0_6b")
    loops = [tengine.ServeLoop(cpu_mesh(n), tcfg, tp, slots=2, max_len=16) for n in (1, 2)]
    got = []
    for loop in loops:
        reqs = [tengine.Request(uid=i, prompt=[1 + i, 5], max_new=4) for i in range(2)]
        got.append([r.generated for r in loop.run_batch(reqs)])
        with pytest.raises(ValueError, match="slots"):
            loop.run_batch([tengine.Request(uid=i, prompt=[1], max_new=1) for i in range(3)])
    assert got[0] == got[1] and all(len(g) == 4 for g in got[0])
    sharding.reset_virtual_devices()


def test_serve_loop_moves_params_onto_its_member_and_serves_bfloat16():
    """The config's own dtype (bfloat16): every request done, ids in range."""
    jcfg = jconfigs.get_config("granite_moe_1b_a400m", reduced=True)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    loop = tengine.ServeLoop(cpu_mesh(), tcfg, tp, slots=3, max_len=32)
    reqs = [tengine.Request(uid=i, prompt=list(range(1, 2 + 2 * i)), max_new=5) for i in range(3)]
    out = loop.run_batch(reqs)
    assert all(r.done and len(r.generated) == 5 for r in out)
    assert all(0 <= tok < tcfg.vocab_size for r in out for tok in r.generated)
    assert loop.caches.k.dtype == torch.bfloat16
