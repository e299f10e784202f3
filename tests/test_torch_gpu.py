"""The Hopper kernels of repro_torch held to their plain versions, on a
card.

Every test here needs a CUDA device and skips without one (a kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Atomics make the kernel's ticket order and float-sum order vary, so it is
held to the plain version by map: same group count and key set, COUNT /
MIN / MAX exact, SUM within 1e-4 of Σ|v| over the group, gap-free tickets
consistent with key_by_ticket, and exact halt signals and event counts
(probe steps aside: the kernel has no claim rounds) for launches that
commit every morsel.  The fused kernel's CTAs take morsels in no fixed
order, so when a launch pauses, its set of committed morsels is checked
(each committed row counted once) and the state after the todo morsels are
replayed is held to the plain version's.  The split route's
ticket kernel is held the same way (one ticket per key, gap-free, the same
key set and count, the same unresolved rows), its segment kernel with
COUNT/MIN/MAX exact and SUM within 1e-4 of Σ|v| over the group."""
import pytest
import torch

from repro_torch.core.hashing import table_capacity
from repro_torch.engine import plan_api as api
from repro_torch.kernels import build
from repro_torch.kernels import fused_groupby as fk
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import ticket_hash as th

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


def _assert_tickets(ks):
    """Gap-free tickets 1..count, each naming its slot's key in
    key_by_ticket (every ticket of the kernel lies within the bound)."""
    for p in range(ks.programs):
        n = int(ks.count[p])
        assert n <= ks.max_groups
        t = ks.ttks[p][ks.ttks[p] > 0]
        assert torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32))
        assert torch.equal(ks.kbt[p][(t - 1).long()], ks.tkeys[p][ks.ttks[p] > 0])
        assert bool((ks.kbt[p, :n] != -1).all())


def _assert_agree(ks, kinfo, ps, pinfo, keys, vals):
    assert torch.equal(kinfo, pinfo)
    assert torch.equal(ks.count, ps.count)
    exact = [0, 1, 2, 4, 5]
    assert torch.equal(ks.events[:, exact], ps.events[:, exact])
    assert torch.equal(ks.events[:, 6:].sum(dim=1), ks.events[:, 1])
    _assert_tickets(ks)
    for p in range(ks.programs):
        for s, (_, kind) in enumerate(SPECS4):
            kk, ka = _by_key(ks, p, s)
            pk, pa = _by_key(ps, p, s)
            assert torch.equal(kk, pk)
            if kind == "sum":
                tol = 1e-4 * _abs_sums(keys, vals, kk & 0xFFFFFFFF)
                assert bool(((ka - pa).abs().double() <= tol).all())
            else:
                assert torch.equal(ka, pa)


def _ones(n, dev):
    return torch.ones(n, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 4])
def test_kernel_matches_plain(cuda, P):
    rows = 64 * M * P
    keys, vals = _data(cuda, rows, 5000, P, masked=100)
    g = 6000
    c = table_capacity(g)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    ktodo, ptodo = _ones(km.shape[0], cuda), _ones(km.shape[0], cuda)
    kw = dict(specs=SPECS4, checked=True, grow_bound=False, threshold=c // 2,
              bound_slack=g - M, collect_events=True)
    ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, programs=P, device=cuda)
    ps = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, programs=P, device=cuda)
    before = fk.fused_consume.launches
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw)
    torch.cuda.synchronize()
    assert fk.fused_consume.launches == before + 1
    ctas, per_program = fk.fused_consume.grid
    assert per_program > 1 and ctas == P * per_program  # many CTAs share each table
    _assert_agree(ks, kinfo, ps, pinfo, keys, vals)
    assert int(ks.events[:, 2].sum()) == 100  # the masked rows
    assert not bool(ktodo.any()) and not bool(ptodo.any())


@pytest.mark.gpu
def test_kernel_pause_and_resume_match_plain(cuda):
    keys, vals = _data(cuda, 128 * M, 20000, 7)
    g1 = 6000
    c1 = table_capacity(g1)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    ktodo, ptodo = _ones(km.shape[0], cuda), _ones(km.shape[0], cuda)
    kw = dict(specs=SPECS4, checked=True, grow_bound=True, collect_events=True)
    ks = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=KINDS, device=cuda)
    ps = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=KINDS, device=cuda)
    kw1 = dict(kw, threshold=c1 // 2, bound_slack=g1 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw1)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw1)
    torch.cuda.synchronize()
    assert int(kinfo[0, fk.INFO_HALTED]) == 1 and int(pinfo[0, fk.INFO_HALTED]) == 1
    assert int(kinfo[0, fk.INFO_FIRST_HALT]) == int(torch.nonzero(ktodo)[0])
    _assert_tickets(ks)
    # the committed morsels' rows are counted once, the others not at all
    committed = ktodo == 0
    assert float(ks.accs[0].sum()) == float((km[committed] != -1).sum())
    g2 = 32768
    c2 = table_capacity(g2)
    ks = fk.grow_fused_state(ks, KINDS, new_max_groups=g2, new_capacity=c2)
    ps = fk.grow_fused_state(ps, KINDS, new_max_groups=g2, new_capacity=c2)
    kw2 = dict(kw, threshold=c2 // 2, bound_slack=g2 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw2)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw2)
    _assert_agree(ks, kinfo, ps, pinfo, keys, vals)  # map, count, total events
    assert int(kinfo[0, fk.INFO_HALTED]) == 0 and not bool(ktodo.any())
    assert float(ks.accs[0].sum()) == float(keys.numel())


@pytest.mark.gpu
def test_kernel_on_many_ctas_issues_no_ticket_past_a_grow_bound(cuda):
    keys, vals = _data(cuda, 256 * M, 50000, 17)
    g = 3000
    c = table_capacity(g)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    todo = _ones(km.shape[0], cuda)
    ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, device=cuda)
    ks, info = fk.fused_consume(ks, km, vm, todo, specs=SPECS4, checked=True,
                                grow_bound=True, threshold=c // 2, bound_slack=g - M,
                                collect_events=True)
    torch.cuda.synchronize()
    assert fk.fused_consume.grid[1] > 1
    assert int(info[0, fk.INFO_HALTED]) == 1 and bool(todo.any())
    assert int(ks.count[0]) <= g and int(info[0, fk.INFO_COUNT]) == int(ks.count[0])
    _assert_tickets(ks)  # key_by_ticket complete: no ticket was dropped
    committed = todo == 0
    assert float(ks.accs[0].sum()) == float((km[committed] != -1).sum())


@pytest.mark.gpu
def test_kernel_under_raise_with_a_bound_just_above_the_distinct_count(cuda):
    keys, vals = _data(cuda, 256 * M, 5000, 19)
    d = int(torch.unique(keys).numel())
    g = d + 1
    c = table_capacity(g)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    todo = _ones(km.shape[0], cuda)
    ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=KINDS, device=cuda)
    ks, info = fk.fused_consume(ks, km, vm, todo, specs=SPECS4, checked=True,
                                grow_bound=False, threshold=c // 2, bound_slack=g - M,
                                collect_events=True)
    torch.cuda.synchronize()
    assert info[0].tolist() == [d, fk.NO_HALT, 0, 0] and not bool(todo.any())
    plan = api.GroupByPlan(
        keys=("k",), aggs=(api.AggSpec("count"),), strategy="concurrent", max_groups=g,
        saturation="raise", raw_keys=True, execution=api.ExecutionPolicy(kernel="fused"),
    )
    out = plan.collect([api.Table({"k": keys[i:i + 65536]})
                        for i in range(0, keys.numel(), 65536)])
    assert int(out["__num_groups__"][0]) == d
    assert int(out["count(*)"][:d].sum()) == keys.numel()


@pytest.mark.gpu
def test_kernel_ends_on_a_full_table(cuda):
    keys, vals = _data(cuda, 8 * M, 4096, 9)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    ks = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=KINDS, device=cuda)
    ks, info = fk.fused_consume(ks, km, vm, _ones(km.shape[0], cuda),
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


# -- the split route: ticket_hash and segment_agg kernels ---------------------


def _assert_ticket_maps_agree(keys, kout, pout, *, full=False):
    """The kernel's tickets vs the plain version's: the same count; one
    gap-free ticket per key, consistent with the kernel's own table and
    key_by_ticket; the same key set and unresolved rows unless the table
    is full (then: a row is unresolved iff its key is not in the table)."""
    kt, ktk, ktt, kkbt, kc = kout
    pt, ptk, ptt, _, pc = pout
    assert int(kc) == int(pc)
    n = int(kc)
    occ = ktt > 0
    tick = ktt[occ]
    assert torch.equal(torch.sort(tick).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32))
    inb = tick <= kkbt.numel()
    assert torch.equal(kkbt[(tick[inb] - 1).long()], ktk[occ][inb])
    key_of = torch.full((n + 1,), -1, dtype=torch.int32, device=keys.device)
    key_of[tick.long()] = ktk[occ]
    valid = keys != -1
    ok = kt >= 0
    assert torch.equal(key_of[(kt[ok] + 1).long()], keys[ok])
    if full:
        assert bool((~ok & valid).any())
        assert torch.equal(torch.isin(keys[valid], ktk[occ]), ok[valid])
    else:
        assert torch.equal(ok, pt >= 0) and torch.equal(ok, valid)
        assert torch.equal(torch.sort(ktk[occ]).values, torch.sort(ptk[ptt > 0]).values)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "heavy", "over_bound", "full"])
def test_ticket_kernel_matches_plain(cuda, case):
    card, cap, g, rows = {"uniform": (5000, 16384, 8192, 64 * M),
                          "heavy": (5000, 16384, 8192, 64 * M),
                          "over_bound": (5000, 16384, 1000, 64 * M),
                          "full": (4096, 1024, 4096, 8 * M)}[case]
    keys, _ = _data(cuda, rows, card, 21, masked=100)
    if case == "heavy":
        keys[::2] = 7
    k32 = keys.to(torch.int32)
    before = th.ticket_hash.launches
    kout = th.ticket_hash(k32, capacity=cap, max_groups=g, morsel_size=M)
    pout = th.ticket_hash_plain(k32, capacity=cap, max_groups=g, morsel_size=M)
    torch.cuda.synchronize()
    assert th.ticket_hash.launches == before + 1
    _assert_ticket_maps_agree(k32, kout, pout, full=case == "full")
    if case == "over_bound":
        assert int(kout[4]) > g
    if case == "full":
        assert int(kout[4]) == cap


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["scatter", "onehot"])
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_segment_kernel_matches_plain(cuda, kind, strategy):
    rows, g = 64 * M, 3000
    gen = torch.Generator(device=cuda).manual_seed(31)
    t = torch.randint(-1, g + 100, (rows,), generator=gen, device=cuda, dtype=torch.int32)
    v = torch.randn(rows, generator=gen, device=cuda)
    before = sa.segment_agg.launches
    got = sa.segment_agg(t, v, num_groups=g, kind=kind, strategy=strategy)
    want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, strategy=strategy)
    torch.cuda.synchronize()
    assert sa.segment_agg.launches == before + 1
    if kind == "sum":
        tol = 1e-4 * sa.segment_agg_plain(t, v.abs(), num_groups=g, kind="sum")
        assert bool(((got - want).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_empty_inputs_launch_nothing(cuda):
    t0, s0 = th.ticket_hash.launches, sa.segment_agg.launches
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    tickets, tkeys, ttks, kbt, count = th.ticket_hash(empty, capacity=64, max_groups=32)
    assert tickets.numel() == 0 and int(count) == 0
    assert bool((tkeys == -1).all()) and bool((ttks == 0).all()) and bool((kbt == -1).all())
    acc = sa.segment_agg(empty, torch.empty(0, device=cuda), num_groups=8, kind="min")
    assert torch.equal(acc, torch.full((8,), float("inf"), device=cuda))
    none = sa.segment_agg(torch.zeros(M, dtype=torch.int32, device=cuda),
                          torch.ones(M, device=cuda), num_groups=0)
    assert none.numel() == 0
    assert (th.ticket_hash.launches, sa.segment_agg.launches) == (t0, s0)


@pytest.mark.gpu
def test_onehot_above_shared_memory_raises_on_the_card(cuda):
    t = torch.zeros(M, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="MAX_ONEHOT_GROUPS"):
        sa.segment_agg(t, torch.ones(M, device=cuda), num_groups=sa.MAX_ONEHOT_GROUPS + 1,
                       strategy="onehot")


@pytest.mark.gpu
def test_failed_build_raises_and_never_falls_back(cuda, monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found (forced by the test)")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    keys = torch.arange(M, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="forced by the test"):
        th.ticket_hash(keys, capacity=2048, max_groups=M)
    with pytest.raises(RuntimeError, match="forced by the test"):
        sa.segment_agg(keys, torch.ones(M, device=cuda), num_groups=M)


@pytest.mark.gpu
@pytest.mark.parametrize("saturation,bound,update", [("raise", 8192, "scatter"),
                                                     ("grow", 256, "scatter"),
                                                     ("raise", 8192, "onehot")])
def test_split_plan_on_the_default_device(cuda, saturation, bound, update):
    keys, vals = _data(cuda, 1 << 18, 5000, 13)
    plan = api.GroupByPlan(
        keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("max", "v")),
        strategy="concurrent", max_groups=bound, saturation=saturation, raw_keys=True,
        execution=api.ExecutionPolicy(kernel="split", update=update),
    )
    chunks = [api.Table({"k": keys[i:i + 65536], "v": vals[i:i + 65536]})
              for i in range(0, keys.numel(), 65536)]
    t0, s0 = th.ticket_hash.launches, sa.segment_agg.launches
    out = plan.collect(chunks)
    assert th.ticket_hash.launches > t0 and sa.segment_agg.launches > s0
    assert out["key"].device.type == "cuda"
    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    mx = torch.full((uk.numel(),), float("-inf"), device=cuda).scatter_reduce_(
        0, inv, vals, "amax")
    n = int(out["__num_groups__"][0])
    assert n == uk.numel()
    order = torch.argsort(out["key"][:n])
    assert torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)
    assert torch.equal(out["max(v)"][:n][order], mx)
