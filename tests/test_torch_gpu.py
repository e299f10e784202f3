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

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import slot_hash, table_capacity
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
    """The kernel's tickets vs the plain version's
    (``ticket_map_discrepancies``): the same count; one gap-free ticket
    per key, consistent with the kernel's own table and key_by_ticket; the
    same key set and unresolved rows unless the table is full (then: a row
    is unresolved iff its key is not in the table, and some row is)."""
    assert th.ticket_map_discrepancies(keys, kout, pout, full=full) == 0
    if full:
        assert bool(((keys != -1) & (kout[0] < 0)).any())


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
@pytest.mark.parametrize("case", ["unique", "ragged_tile"])
def test_ticket_kernel_on_unique_keys_and_a_ragged_tile(cuda, case):
    """Every row inserts (2^20 distinct keys), or the rows end partway
    through a tile of the kernel (3·M rows)."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    if case == "unique":
        rows, cap, g = 1 << 20, 1 << 21, 1 << 20
        keys = torch.randperm(rows, generator=gen, device=cuda).to(torch.int32)
    else:
        rows, cap, g = 3 * M, 4096, 2048
        keys = torch.randint(0, 1500, (rows,), generator=gen, device=cuda,
                             dtype=torch.int32)
        keys[-77:] = -1
    before = th.ticket_hash.launches
    kout = th.ticket_hash(keys, capacity=cap, max_groups=g, morsel_size=M)
    pout = th.ticket_hash_plain(keys, capacity=cap, max_groups=g, morsel_size=M)
    torch.cuda.synchronize()
    assert th.ticket_hash.launches == before + 1
    _assert_ticket_maps_agree(keys, kout, pout)
    if case == "unique":
        assert int(kout[4]) == rows and bool((kout[0] >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unique", "crowded", "skewed"])
def test_ticket_kernel_builds_a_large_sparse_table_by_regions(cuda, case):
    """A table past the L2 with one row per 16 slots: where the sampled keys
    are mostly distinct the kernel stages the rows by region and builds
    each region in shared memory.  "crowded" adds 3000 distinct keys homed
    in one region (its slab of 1024 rows overflows), keys whose home slots
    are the last six of that region (those staged run past its end) and
    EMPTY rows; both go to the overflow pass.  "skewed" puts one key on half
    the rows, so the sample chooses tile mode."""
    rows, cap, g = 1 << 19, 1 << 23, 1 << 20
    gen = torch.Generator(device=cuda).manual_seed(53)
    keys = torch.randperm(1 << 24, generator=gen, device=cuda)[:rows].to(torch.int32)
    if case == "crowded":
        cand = torch.arange(1 << 26, device=cuda, dtype=torch.int32)
        home = slot_hash(cand, cap)
        in_region = (home >> 13) == 100
        near_end = cand[in_region & ((home & 8191) >= 8186)]
        homed = cand[in_region & ((home & 8191) < 8186)][:3000]
        assert near_end.numel() >= 20 and homed.numel() == 3000
        keys[:near_end.numel()] = near_end
        keys[near_end.numel():near_end.numel() + 3000] = homed
    elif case == "skewed":
        keys[1::2] = 7
    if case != "unique":
        keys[-300:] = -1
    kout = th.ticket_hash(keys, capacity=cap, max_groups=g, morsel_size=M)
    pout = th.ticket_hash_plain(keys, capacity=cap, max_groups=g, morsel_size=M)
    torch.cuda.synchronize()
    _assert_ticket_maps_agree(keys, kout, pout)


def _segment_values(gen, rows, dev, kind):
    """Normal values with negatives, -0.0 and +0.0, and ±inf for MIN/MAX
    (SUM's tolerance would be undefined on an infinite group)."""
    v = torch.randn(rows, generator=gen, device=dev)
    v[::97] = -0.0
    v[1::89] = 0.0
    if kind in ("min", "max"):
        v[2::1013] = float("inf")
        v[3::1009] = float("-inf")
    return v


def _assert_segment_agrees(t, v, got, want, kind, g):
    if kind == "sum":
        tol = 1e-4 * sa.segment_agg_plain(t, v.abs(), num_groups=g, kind="sum")
        assert bool(((got - want).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_segment_kernel_on_a_hot_key(cuda, kind):
    """One ticket holds >= 50% of 2^20 rows, the rest spread over
    G = 2^14 with tickets of -1 and >= G mixed in: the warp and CTA folds
    of the hot ticket."""
    rows, g = 1 << 20, 1 << 14
    gen = torch.Generator(device=cuda).manual_seed(43)
    t = torch.randint(-1, g + 100, (rows,), generator=gen, device=cuda, dtype=torch.int32)
    hot = torch.rand(rows, generator=gen, device=cuda) < 0.55
    t[hot] = 5
    v = _segment_values(gen, rows, cuda, kind)
    before = sa.segment_agg.launches
    got = sa.segment_agg(t, v, num_groups=g, kind=kind, strategy="scatter")
    want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, strategy="scatter")
    torch.cuda.synchronize()
    assert sa.segment_agg.launches == before + 1
    assert int((t == 5).sum()) >= rows // 2
    _assert_segment_agrees(t, v, got, want, kind, g)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["distinct", "paired"])
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_segment_kernel_with_more_tickets_per_cta_than_fold_slots(cuda, kind, layout):
    """Over 8192 distinct tickets per CTA.  "distinct": 2^22 rows over
    2^22 tickets, so a CTA folds a slot per row and turns to device atomics
    after its first tile.  "paired": 2^23 rows where each ticket comes twice
    in one thread's tile (the table pays) and a quarter of the tickets share
    their low 13 bits, so the CTA flushes mid-way and rows that find no
    slot within the probes fold into device memory."""
    rows = 1 << (22 if layout == "distinct" else 23)
    g = 1 << 22
    gen = torch.Generator(device=cuda).manual_seed(47)
    t = torch.randint(0, g, (rows,), generator=gen, device=cuda, dtype=torch.int32)
    if layout == "paired":
        crowd = torch.rand(rows, generator=gen, device=cuda) < 0.25
        t[crowd] = (t[crowd] & ~8191) | 77
        pairs = t.view(-1, 1024)
        pairs[:, 512:] = pairs[:, :512]
    v = _segment_values(gen, rows, cuda, kind)
    got = sa.segment_agg(t, v, num_groups=g, kind=kind, strategy="scatter")
    want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, strategy="scatter")
    torch.cuda.synchronize()
    _assert_segment_agrees(t, v, got, want, kind, g)


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


# -- the scan route: scan_ticket (scan_ticket_kernel) and serialized -----------


def _scan_pair(keys, M_rows, cap, g, **kw):
    """One scan_ticket launch and its plain version from the same fresh
    table over the same morsels: ((tickets, table, todo, info) each)."""
    km = keys.to(torch.int32).reshape(-1, M_rows).contiguous()
    out = []
    for fn in (fk.scan_ticket, fk.scan_ticket_plain):
        t = tk.make_table(cap, g, device=km.device)
        todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
        tickets, info = fn(t, km, todo, **kw)
        out.append((tickets, t, todo, info))
    torch.cuda.synchronize()
    return km, out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "zipf", "hot"])
def test_scan_ticket_matches_plain(cuda, case):
    keys, _ = _data(cuda, 256 * M, 20000, 51, masked=300)
    if case == "zipf":
        gen = torch.Generator(device=cuda).manual_seed(52)
        keys = torch.remainder((torch.rand(keys.shape[0], generator=gen, device=cuda)
                                ** -1.5).long(), 20000)
    if case == "hot":
        keys[::2] = 7
    g = int(torch.unique(keys[keys != 0xFFFFFFFF]).numel())
    cap = table_capacity(g)
    before = fk.scan_ticket.launches
    km, (k, p) = _scan_pair(keys, 4096, cap, g, checked=True, threshold=cap // 2,
                            collect_events=True)
    assert fk.scan_ticket.launches == before + 1
    assert fk.scan_ticket.grid[1] > 1
    assert torch.equal(k[3], p[3]) and not bool(k[2].any())
    assert fk.scan_ticket_discrepancies(km, k[:2], p[:2]) == 0


@pytest.mark.gpu
def test_scan_ticket_grow_pause_and_replay(cuda):
    """A GROW bound of half the keys: the launch pauses partway, commits
    whole morsels only (no ticket past the bound, -1 on every row of a
    morsel left todo), and the replay after growing the bound ends where
    the plain version's replay ends."""
    keys, _ = _data(cuda, 256 * M, 1 << 20, 53)
    d = int(torch.unique(keys).numel())
    g1, Mr = d // 2, 4096
    cap = table_capacity(4 * g1)
    km, (k, p) = _scan_pair(keys, Mr, cap, g1, checked=True, grow_bound=True,
                            threshold=cap // 2, bound_slack=g1 - Mr)
    for tickets, t, todo, info in (k, p):
        left = todo.bool()
        assert int(info[0, fk.INFO_HALTED]) == 1 and 0 < int(left.sum()) < km.shape[0]
        assert int(t.count) <= g1 and int(info[0, fk.INFO_FIRST_HALT]) == int(
            torch.nonzero(left)[0])
        assert bool((tickets[left] == -1).all()) and bool((tickets[~left] >= 0).all())
    ends = []
    for (tickets, t, todo, info), fn in zip((k, p), (fk.scan_ticket, fk.scan_ticket_plain)):
        t2 = resize.grow_bound(t, 4 * g1)
        t2b, info2 = fn(t2, km, todo, checked=True, grow_bound=True, threshold=cap // 2,
                        bound_slack=4 * g1 - Mr)
        assert int(info2[0, fk.INFO_HALTED]) == 0 and int(t2.count) == d
        whole = torch.where(t2b >= 0, t2b, tickets)  # each row's ticket, either launch
        ends.append((whole, t2))
    torch.cuda.synchronize()
    assert fk.scan_ticket_discrepancies(km, ends[0], ends[1]) == 0


@pytest.mark.gpu
def test_scan_ticket_ends_on_a_saturated_unchecked_table(cuda):
    keys = torch.randint(0, 4096, (8 * M,), device=cuda)
    km, (k, p) = _scan_pair(keys, M, 1024, 4096, checked=False, collect_events=True)
    assert int(k[1].count) == 1024 and int(k[3][0, fk.INFO_SAT]) == 1
    assert not bool(k[2].any())  # unchecked: every morsel commits
    assert fk.scan_ticket_discrepancies(km, k[:2], p[:2], full=True) == 0


def _scan_from(table, km, **kw):
    """scan_ticket and scan_ticket_plain on the same morsels, each from its
    own copy of ``table``, events on: ((tickets, table, todo, info,
    events) each), every histogram summing to its rows."""
    out = []
    for fn in (fk.scan_ticket, fk.scan_ticket_plain):
        t = tk.TicketTable(*(x.clone() for x in table))
        todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
        ev = torch.zeros(14, dtype=torch.int32, device=km.device)
        tickets, info = fn(t, km, todo, collect_events=True, events=ev, **kw)
        out.append((tickets, t, todo, info, ev))
    torch.cuda.synchronize()
    for *_, ev in out:
        assert int(ev[6:].sum()) == int(ev[1])
    return out


def _tile_rows():
    return fk.SCAN_BLOCK_THREADS * 4  # the kernel's tile: threads × 4 rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["many_morsels", "hot_key_tiles", "ragged_morsel",
                                  "second_launch"])
def test_scan_ticket_tiles_and_key_cache_match_plain(cuda, case):
    """The tile protocol against the plain version: a CTA's key cache
    reused over many more morsels than CTAs; a hot key over several tiles
    of each morsel; a morsel size that is no multiple of the tile; and a
    second launch on a table that holds most of its keys already (a fresh
    cache over found keys)."""
    gen = torch.Generator(device=cuda).manual_seed(61)
    rows, card = {"many_morsels": (32, 300), "hot_key_tiles": (4 * _tile_rows(), 5000),
                  "ragged_morsel": (3000, 20000), "second_launch": (4096, 30000)}[case]
    npm = {"many_morsels": 2048, "hot_key_tiles": 16}.get(case, 64)
    keys = torch.randint(0, card, (npm * rows,), generator=gen, device=cuda, dtype=torch.int32)
    keys[:: 97] = -1  # EMPTY rows
    if case == "hot_key_tiles":
        keys[torch.rand(keys.shape[0], generator=gen, device=cuda) < 0.75] = 7
    km = keys.reshape(npm, rows)
    g = int(torch.unique(keys[keys != -1]).numel())
    table = tk.make_table(table_capacity(g), g, device=cuda)
    if case == "second_launch":  # a first launch inserts most of the keys
        first = keys[torch.randperm(keys.shape[0], generator=gen, device=cuda)].reshape(npm, rows)
        todo = torch.ones(npm, dtype=torch.int32, device=cuda)
        fk.scan_ticket(table, first[:48].contiguous(), todo[:48], checked=True,
                       threshold=table.capacity // 2)
        assert 0 < int(table.count) < g
    kw = dict(checked=True, threshold=table.capacity // 2)
    k, p = _scan_from(table, km, **kw)
    if case == "many_morsels":
        assert 2 * fk.scan_ticket.grid[0] <= npm
    assert torch.equal(k[3], p[3]) and not bool(k[2].any())
    assert torch.equal(k[4][[0, 1, 2, 4, 5]], p[4][[0, 1, 2, 4, 5]])
    assert fk.scan_ticket_discrepancies(km, k[:2], p[:2]) == 0


@pytest.mark.gpu
def test_scan_ticket_morsel_saturating_in_its_second_tile_stays_todo(cuda):
    """Under `checked`, a morsel whose second tile finds the table full
    commits nothing: every row -1 (the first tile's too), the morsel stays
    todo, and the kernel's inserts of the first tile stay in the table (the
    plain version claims the whole morsel at once)."""
    tile = _tile_rows()
    gen = torch.Generator(device=cuda).manual_seed(62)
    head = torch.randint(0, 1000, (tile,), generator=gen, device=cuda, dtype=torch.int32)
    tail = torch.arange(1000, 1000 + tile, device=cuda, dtype=torch.int32)
    km = torch.cat([head, tail]).reshape(1, 2 * tile)
    table = tk.make_table(1024, 4096, device=cuda)
    out = _scan_from(table, km, checked=True, threshold=1 << 20)
    for tickets, t, todo, info, ev in out:
        assert bool((tickets == -1).all()) and int(todo[0]) == 1
        assert info[0].tolist()[1:] == [0, 1, 1]  # first todo morsel 0, saturated, halted
        assert int(t.count) == 1024 and int(info[0, fk.INFO_COUNT]) == 1024
        assert ev.tolist()[:6] == [0, 0, 0, 0, 1, 1]  # one saturation, one pause
    assert bool(torch.isin(head, out[0][1].keys).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["off", "scan_body"])
def test_raise_scan_stream_makes_one_ticket_launch_per_chunk(cuda, kernel):
    keys, vals = _data(cuda, 8 * 64 * M, 3000, 55)
    plan = api.GroupByPlan(
        keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("sum", "v")),
        strategy="concurrent", max_groups=4096, raw_keys=True,
        execution=api.ExecutionPolicy(kernel=kernel))
    chunks = [api.Table({"k": keys[i:i + 64 * M], "v": vals[i:i + 64 * M]})
              for i in range(0, keys.shape[0], 64 * M)]
    t0, s0 = fk.scan_ticket.launches, sa.segment_agg.launches
    out = plan.collect(chunks)
    assert fk.scan_ticket.launches - t0 == len(chunks)
    assert sa.segment_agg.launches - s0 == (2 * len(chunks) if kernel == "scan_body" else 0)
    uk, cnt = torch.unique(keys, return_counts=True)
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["off", "scan_body"])
def test_scan_stream_takes_zero_row_and_short_chunks(cuda, kernel):
    plan = api.GroupByPlan(
        keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("min", "v")),
        strategy="concurrent", max_groups=64, raw_keys=True,
        execution=api.ExecutionPolicy(kernel=kernel))
    empty = api.Table({"k": torch.zeros(0, dtype=torch.int64, device=cuda),
                       "v": torch.zeros(0, device=cuda)})
    short = api.Table({"k": torch.arange(10, device=cuda), "v": torch.arange(10.0, device=cuda)})
    t0 = fk.scan_ticket.launches
    out = plan.collect([empty, short, empty])
    assert fk.scan_ticket.launches - t0 == 1  # an empty chunk launches nothing
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == 10 and torch.equal(out["key"][:n][order], torch.arange(10, device=cuda))
    assert torch.equal(out["min(v)"][:n][order], torch.arange(10.0, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_serialized_kernel_matches_plain(cuda, kind):
    gen = torch.Generator(device=cuda).manual_seed(57)
    t = torch.randint(-1, 700, (1 << 13,), generator=gen, device=cuda, dtype=torch.int32)
    v = torch.randn(1 << 13, generator=gen, device=cuda)
    acc = torch.full((650,), sa._NEUTRAL[kind], device=cuda)
    want = sa.serialized_agg_plain(acc.cpu().clone(), t.cpu(), v.cpu(), kind=kind)
    before = sa.serialized_agg.launches
    got = sa.serialized_agg(acc, t, v, kind=kind)
    torch.cuda.synchronize()
    assert got is acc and sa.serialized_agg.launches == before + 1
    assert torch.equal(got.cpu(), want)  # one order of float adds: exact
