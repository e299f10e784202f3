"""The Hopper kernel of repro_torch held to its plain version, on a card.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Atomics make the kernel's ticket order and float-sum order vary, so it is
held to the plain version by map: same group count and key set, COUNT /
MIN / MAX exact, SUM within 1e-4 of Σ|v| over the group, gap-free tickets
consistent with key_by_ticket, and exact halt signals and event counts
(probe steps aside: the kernel has no claim rounds)."""
import pytest
import torch

from repro_torch.core.hashing import table_capacity
from repro_torch.engine import plan_api as api
from repro_torch.kernels import fused_groupby as fk

SPECS4 = ((-1, "count"), (0, "sum"), (0, "min"), (0, "max"))
KINDS = tuple(k for _, k in SPECS4)
M = 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused kernel has no CPU mode)")
    return torch.device("cuda")


def _data(dev, rows, card, seed, masked=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, card, (rows,), generator=g, device=dev, dtype=torch.int64)
    if masked:
        keys[:masked] = 0xFFFFFFFF
    vals = torch.randn(rows, generator=g, device=dev)
    return keys, vals


def _by_key(state, p, s):
    n = int(state.count[p])
    kb = state.kbt[p, :n].to(torch.int64)
    order = torch.argsort(kb)
    return kb[order], state.accs[s, p, :n][order]


def _abs_sums(keys, vals, at):
    uk, inv = torch.unique(keys, return_inverse=True)
    a = torch.zeros(uk.numel(), dtype=torch.float64, device=keys.device)
    a.index_add_(0, inv, vals.double().abs())
    return a[torch.searchsorted(uk, at)]


def _assert_agree(ks, kinfo, ps, pinfo, keys, vals):
    assert torch.equal(kinfo, pinfo)
    assert torch.equal(ks.count, ps.count)
    exact = [0, 1, 2, 4, 5]
    assert torch.equal(ks.events[:, exact], ps.events[:, exact])
    assert torch.equal(ks.events[:, 6:].sum(dim=1), ks.events[:, 1])
    for p in range(ks.programs):
        n = int(ks.count[p])
        t = ks.ttks[p][ks.ttks[p] > 0]
        assert torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32))
        assert torch.equal(ks.kbt[p][(t - 1).long()], ks.tkeys[p][ks.ttks[p] > 0])
        for s, (_, kind) in enumerate(SPECS4):
            kk, ka = _by_key(ks, p, s)
            pk, pa = _by_key(ps, p, s)
            assert torch.equal(kk, pk)
            if kind == "sum":
                tol = 1e-4 * _abs_sums(keys, vals, kk & 0xFFFFFFFF)
                assert bool(((ka - pa).abs().double() <= tol).all())
            else:
                assert torch.equal(ka, pa)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 4])
def test_kernel_matches_plain(cuda, P):
    rows = 64 * M * P
    keys, vals = _data(cuda, rows, 5000, P, masked=100)
    g = 6000
    c = table_capacity(g)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    start = torch.zeros(P, dtype=torch.int32, device=cuda)
    kw = dict(specs=SPECS4, checked=True, grow_bound=False, threshold=c // 2,
              bound_slack=g - M, collect_events=True)
    ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, programs=P, device=cuda)
    ps = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, programs=P, device=cuda)
    before = fk.fused_consume.launches
    ks, kinfo = fk.fused_consume(ks, km, vm, start, **kw)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, start, **kw)
    torch.cuda.synchronize()
    assert fk.fused_consume.launches == before + 1
    _assert_agree(ks, kinfo, ps, pinfo, keys, vals)
    assert int(ks.events[:, 2].sum()) == 100  # the masked rows


@pytest.mark.gpu
def test_kernel_pause_and_resume_match_plain(cuda):
    keys, vals = _data(cuda, 128 * M, 20000, 7)
    g1 = 6000
    c1 = table_capacity(g1)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    kw = dict(specs=SPECS4, checked=True, grow_bound=True, collect_events=True)
    ks = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=KINDS, device=cuda)
    ps = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=KINDS, device=cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw1 = dict(kw, threshold=c1 // 2, bound_slack=g1 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, zero, **kw1)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, zero, **kw1)
    _assert_agree(ks, kinfo, ps, pinfo, keys, vals)
    first = int(kinfo[0, fk.INFO_FIRST_HALT])
    assert int(kinfo[0, fk.INFO_HALTED]) == 1 and 0 < first < km.shape[0]
    g2 = 32768
    c2 = table_capacity(g2)
    ks = fk.grow_fused_state(ks, KINDS, new_max_groups=g2, new_capacity=c2)
    ps = fk.grow_fused_state(ps, KINDS, new_max_groups=g2, new_capacity=c2)
    resume = torch.tensor([first], dtype=torch.int32, device=cuda)
    kw2 = dict(kw, threshold=c2 // 2, bound_slack=g2 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, resume, **kw2)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, resume, **kw2)
    _assert_agree(ks, kinfo, ps, pinfo, keys, vals)
    assert int(kinfo[0, fk.INFO_HALTED]) == 0
    assert float(ks.accs[0].sum()) == float(keys.numel())


@pytest.mark.gpu
def test_kernel_ends_on_a_full_table(cuda):
    keys, vals = _data(cuda, 8 * M, 4096, 9)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    ks = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=KINDS, device=cuda)
    ks, info = fk.fused_consume(ks, km, vm, torch.zeros(1, dtype=torch.int32, device=cuda),
                                specs=SPECS4, checked=False, grow_bound=False,
                                collect_events=True)
    torch.cuda.synchronize()
    assert int(ks.count[0]) == 1024 and int(info[0, fk.INFO_SAT]) == 1
    assert int(ks.events[0, 0]) == 8  # unchecked: every morsel commits


@pytest.mark.gpu
@pytest.mark.parametrize("saturation,bound", [("raise", 8192), ("grow", 256)])
def test_plan_on_the_default_device(cuda, saturation, bound):
    keys, vals = _data(cuda, 1 << 18, 5000, 11)
    plan = api.GroupByPlan(
        keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("max", "v")),
        strategy="concurrent", max_groups=bound, saturation=saturation, raw_keys=True,
        execution=api.ExecutionPolicy(kernel="fused"),
    )
    chunks = [api.Table({"k": keys[i:i + 65536], "v": vals[i:i + 65536]})
              for i in range(0, keys.numel(), 65536)]
    before = fk.fused_consume.launches
    out = plan.collect(chunks)
    assert fk.fused_consume.launches > before
    assert out["key"].device.type == "cuda"
    uk, cnt = torch.unique(keys, return_counts=True)
    n = int(out["__num_groups__"][0])
    assert n == uk.numel()
    order = torch.argsort(out["key"][:n])
    assert torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)
