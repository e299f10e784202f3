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
COUNT/MIN/MAX exact and SUM within 1e-4 of Σ|v| over the group.  The table
ops (GET_OR_INSERT into a carried table, lookup, migrate) are held by
``table_ops.table_map_discrepancies`` (lookup bit for bit), with any host
sync inside a wrapper an error, and every executor site that merges,
grows, looks up or migrates a table launches them on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import slot_hash, table_capacity
from repro_torch.engine import plan_api as api
from repro_torch.kernels import build
from repro_torch.kernels import fused_groupby as fk
from repro_torch.kernels import hybrid_registers as hr
from repro_torch.kernels import preagg as pa
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import table_ops as tops
from repro_torch.kernels import ticket_hash as th

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

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
    regs = torch.zeros((1, 8), device=cuda)
    with pytest.raises(RuntimeError, match="forced by the test"):
        hr.hybrid_registers(keys, keys[:8], [None], regs, kinds=("count",))


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


def _serialized_edges(rng, n, g, kind):
    """n (ticket, value) rows over g groups, with a ticket repeated on the
    next row and two rows on, tickets of -1 and >= g, and, for min / max,
    values of -0.0, +0.0 and ±inf; and a starting accumulator."""
    t = rng.integers(0, g, size=n).astype(np.int32)
    t[1::5] = t[0::5][: t[1::5].size]   # the previous row's ticket
    t[2::7] = t[0::7][: t[2::7].size]   # the ticket of two rows before
    t[3::11] = -1
    t[4::13] = g + (np.arange(t[4::13].size) % 3)
    v = rng.normal(size=n).astype(np.float32)
    acc = (rng.normal(size=g) * 2).astype(np.float32)
    if kind in ("min", "max"):
        v[::17], v[5::19], v[6::23], v[7::29] = -0.0, 0.0, np.inf, -np.inf
        acc[::3] = np.inf if kind == "min" else -np.inf
        acc[1::5] = -0.0
    elif kind == "count":
        acc = np.zeros(g, np.float32)
    return t, v, acc


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("case", ["shared_cap", "past_cap", "forwarding", "ragged", "misaligned"])
def test_serialized_kernel_edges_bit_for_bit(cuda, case, kind):
    """The accumulator in shared memory at its cap, in device memory just
    past it; tickets repeated one and two rows apart (the register
    forward); a row count that is no multiple of the tile or the group;
    columns that are not 16-byte aligned (4-byte staging)."""
    cap = sa.MAX_SERIALIZED_SHARED_GROUPS
    n, g = {"shared_cap": (1 << 14, cap), "past_cap": (1 << 14, cap + 1),
            "forwarding": (1 << 13, 24), "ragged": (3 * 1024 + 5, 700),
            "misaligned": (2 * 1024 + 3, 300)}[case]
    rng = np.random.default_rng(91 + len(case) + 7 * KINDS.index(kind))
    t, v, acc0 = _serialized_edges(rng, n + 1, g, kind)
    t_d, v_d = torch.from_numpy(t).to(cuda), torch.from_numpy(v).to(cuda)
    # a view one row in: 4 bytes past a 16-byte boundary
    t_d, v_d = (t_d[1:], v_d[1:]) if case == "misaligned" else (t_d[:n], v_d[:n])
    want = sa.serialized_agg_plain(torch.from_numpy(acc0.copy()), t_d.cpu(), v_d.cpu(),
                                   kind=kind)
    acc = torch.from_numpy(acc0).to(cuda)
    before = sa.serialized_agg.launches
    got = sa.serialized_agg(acc, t_d, v_d, kind=kind)
    torch.cuda.synchronize()
    assert got is acc and sa.serialized_agg.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))  # bit for bit


# -- the hybrid register fold and the default plan ------------------------------

HR_KINDS = ("count", "sum", "min", "max")


def _hybrid_case(dev, case, rows, R, seed):
    """Keys of one class (int32 bit patterns), R heavy keys (the class's
    most frequent keys, EMPTY-padded) and one value column with -0.0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if case == "unique":
        keys = torch.randperm(rows, generator=g, device=dev)
    elif case == "heavy_unique":
        keys = torch.randperm(rows, generator=g, device=dev)
        keys[torch.rand(rows, generator=g, device=dev) < 1 / 3] = 7
    else:
        keys = torch.randint(0, 1000 if case == "low" else 50000, (rows,), generator=g,
                             device=dev)
        if case == "heavy":
            keys[torch.rand(rows, generator=g, device=dev) < 0.5] = 0x9E3779B9
    keys = keys.to(torch.int64)
    keys[:5] = 0xFFFFFFFF  # EMPTY rows never hit a register
    k32 = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)
    uk, cnt = torch.unique(k32[k32 != -1], return_counts=True)
    heavy = torch.full((R,), -1, dtype=torch.int32, device=dev)
    top = uk[torch.argsort(cnt, descending=True)][: R - 1]  # one EMPTY pad at least
    heavy[: top.numel()] = top
    vals = torch.randn(rows, generator=g, device=dev)
    vals[::97] = -0.0
    return k32, heavy, vals


def _assert_registers_match(got_regs, want_regs, got_tail, want_tail, keys, heavy, vals):
    assert torch.equal(got_tail, want_tail)
    for s, kind in enumerate(HR_KINDS):
        if kind == "sum":
            hit = keys[None, :] == heavy[:, None]
            absum = torch.where(hit, vals.abs()[None, :], 0.0).sum(dim=1)
            assert bool(((got_regs[s] - want_regs[s]).abs() <= 1e-4 * absum + 1e-6).all())
        else:
            assert torch.equal(got_regs[s], want_regs[s]), kind


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 64, 256])
@pytest.mark.parametrize("case", ["low", "heavy", "unique", "heavy_unique"])
def test_hybrid_registers_kernel_matches_plain(cuda, case, R):
    keys, heavy, vals = _hybrid_case(cuda, case, 1 << 18, R, 61 + R)
    regs0 = torch.stack([torch.full((R,), sa._NEUTRAL[k], device=cuda) for k in HR_KINDS])
    regs0[1] = 3.0  # carried state folds in place
    planes = [None, vals, vals, vals]
    want_regs = regs0.clone()
    want_tail = hr.hybrid_registers_plain(keys, heavy, planes, want_regs, kinds=HR_KINDS)
    got_regs = regs0.clone()
    before = hr.hybrid_registers.launches
    got_tail = hr.hybrid_registers(keys, heavy, planes, got_regs, kinds=HR_KINDS)
    torch.cuda.synchronize()
    assert hr.hybrid_registers.launches == before + 1
    _assert_registers_match(got_regs, want_regs, got_tail, want_tail, keys, heavy, vals)


@pytest.mark.gpu
def test_hybrid_registers_kernel_edges(cuda):
    keys = torch.arange(3000, dtype=torch.int32, device=cuda) % 5  # a ragged last tile
    heavy = torch.tensor([3, 3, -1, 1], dtype=torch.int32, device=cuda)  # a repeated key
    regs = torch.zeros((1, 4), device=cuda)
    want = torch.zeros((1, 4), device=cuda)
    tail = hr.hybrid_registers(keys, heavy, [None], regs, kinds=("count",))
    want_tail = hr.hybrid_registers_plain(keys, heavy, [None], want, kinds=("count",))
    torch.cuda.synchronize()
    assert torch.equal(regs, want) and regs[0].tolist() == [600.0, 0.0, 0.0, 600.0]
    assert torch.equal(tail, want_tail)
    before = hr.hybrid_registers.launches
    out = hr.hybrid_registers(keys[:0], heavy, [None], regs, kinds=("count",))
    assert out.numel() == 0 and hr.hybrid_registers.launches == before  # nothing to launch
    with pytest.raises(ValueError, match="MAX_REGISTERS"):
        hr.hybrid_registers(keys, keys[:hr.MAX_REGISTERS + 1], [None],
                            torch.zeros((1, hr.MAX_REGISTERS + 1), device=cuda),
                            kinds=("count",))


def _planes_of(vals, S):
    """S planes cycling over the kinds, each with a value column of its own."""
    kinds = tuple(HR_KINDS[s % 4] for s in range(S))
    planes = [None if k == "count" else vals * (1.0 + s) - s for s, k in enumerate(kinds)]
    regs0 = torch.stack([torch.full((1,), sa._NEUTRAL[k], device=vals.device) for k in kinds])
    return kinds, planes, regs0


def _assert_planes_match(kinds, planes, got_regs, want_regs, got_tail, want_tail, keys,
                         heavy):
    assert torch.equal(got_tail, want_tail)
    hit = (keys[None, :] == heavy[:, None]) & (keys != -1)[None, :]
    for s, kind in enumerate(kinds):
        if kind == "sum":
            absum = torch.where(hit, planes[s].abs()[None, :], 0.0).sum(dim=1)
            assert bool(((got_regs[s] - want_regs[s]).abs() <= 1e-4 * absum + 1e-6).all())
        else:
            assert torch.equal(got_regs[s], want_regs[s]), (s, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("R,S", [(8, 8), (8, 7), (8, 9), (7, 4), (9, 4), (16, 4), (64, 1),
                                 (65, 1), (8, 16), (1, 4), (1, 16)])
def test_hybrid_registers_kernel_size_paths(cuda, R, S):
    """The per-thread copies' limits (R <= 8 keys compared in registers,
    S x R <= 64): at them, just under them and just past each (per-warp
    copies), S = 16 and R = 1."""
    keys, _, vals = _hybrid_case(cuda, "low", 1 << 17, R, 83 + R + S)
    uk, cnt = torch.unique(keys[keys != -1], return_counts=True)
    heavy = uk[torch.argsort(cnt, descending=True)][:R].contiguous()  # R live keys
    kinds, planes, regs0 = _planes_of(vals, S)
    regs0 = regs0.expand(S, R).contiguous()
    want_regs, got_regs = regs0.clone(), regs0.clone()
    want_tail = hr.hybrid_registers_plain(keys, heavy, planes, want_regs, kinds=kinds)
    before = hr.hybrid_registers.launches
    got_tail = hr.hybrid_registers(keys, heavy, planes, got_regs, kinds=kinds)
    torch.cuda.synchronize()
    assert hr.hybrid_registers.launches == before + 1
    assert int((got_tail == -1).sum()) > 5  # rows folded, beside the 5 EMPTY rows
    _assert_planes_match(kinds, planes, got_regs, want_regs, got_tail, want_tail, keys, heavy)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [8, 64])
@pytest.mark.parametrize("layout", ["eight_per_warp", "ragged", "misaligned"])
def test_hybrid_registers_kernel_row_layouts(cuda, layout, R):
    """Every warp's 32 rows hit 8 registers; a row count that is no
    multiple of the tile or of the 4-row key vector; a key column that is
    not 16-byte aligned (4-byte rows).  R = 8: per-thread copies; R = 64 at
    S = 4: per-warp copies."""
    g = torch.Generator(device=cuda).manual_seed(97 + R)
    rows = {"eight_per_warp": 1 << 16, "ragged": 3 * 4096 + 7, "misaligned": 5 * 1024 + 2}[layout]
    heavy = torch.randint(-(1 << 31), 1 << 31, (R,), generator=g, device=cuda,
                          dtype=torch.int64).to(torch.int32)
    heavy[heavy == -1] = 5
    keys = torch.randint(0, 1 << 20, (rows + 1,), generator=g, device=cuda).to(torch.int32)
    if layout == "eight_per_warp":
        # row i of lane l's vector: register (5 l + i) % 8, so each of the
        # warp's four row steps meets all 8, as does each thread's vector
        at = torch.arange(rows // 2, device=cuda)
        keys[: rows // 2] = heavy[(at // 4 + at) % 8]
    else:
        hot = torch.rand(rows + 1, generator=g, device=cuda) < 0.6
        keys = torch.where(hot, heavy[torch.randint(0, R, (rows + 1,), generator=g,
                                                    device=cuda)], keys)
    keys = keys[1:] if layout == "misaligned" else keys[:rows]
    vals = torch.randn(rows, generator=g, device=cuda)
    kinds, planes, regs0 = _planes_of(vals, 4)
    regs0 = regs0.expand(4, R).contiguous()
    want_regs, got_regs = regs0.clone(), regs0.clone()
    want_tail = hr.hybrid_registers_plain(keys, heavy, planes, want_regs, kinds=kinds)
    got_tail = hr.hybrid_registers(keys, heavy, planes, got_regs, kinds=kinds)
    torch.cuda.synchronize()
    _assert_planes_match(kinds, planes, got_regs, want_regs, got_tail, want_tail, keys, heavy)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["auto_low", "auto_heavy_unique", "hybrid", "direct"])
def test_default_plans_on_the_default_device(cuda, case):
    rows = 1 << 18
    g = torch.Generator(device=cuda).manual_seed(71)
    if case == "auto_low" or case == "direct":
        keys = torch.randint(0, 1000, (rows,), generator=g, device=cuda)
    else:
        keys = torch.randperm(rows, generator=g, device=cuda)
        keys[torch.rand(rows, generator=g, device=cuda) < 1 / 3] = 7
    vals = torch.randn(rows, generator=g, device=cuda)
    ex = api.ExecutionPolicy(ticketing="direct", key_domain=1000) if case == "direct" \
        else api.ExecutionPolicy()
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("max", "v")),
                           strategy="hybrid" if case == "hybrid" else "auto", raw_keys=True,
                           execution=ex)
    h0, s0 = hr.hybrid_registers.launches, sa.segment_agg.launches
    handle = plan.stream([api.Table({"k": keys[i:i + 65536], "v": vals[i:i + 65536]})
                          for i in range(0, rows, 65536)])
    out = handle.result()
    inner = handle.executor._inner
    assert handle.executor._device.type == "cuda"
    assert handle.executor._resolved.execution.kernel == "scan_body"
    assert sa.segment_agg.launches > s0
    if case in ("auto_heavy_unique", "hybrid"):
        assert type(inner).__name__ == "_HybridExecutor"
        assert hr.hybrid_registers.launches > h0
    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    mx = torch.full((uk.numel(),), float("-inf"), device=cuda).scatter_reduce_(
        0, inv, vals, "amax")
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)
    assert torch.equal(out["max(v)"][:n][order], mx)


# -- the partitioned route's pre-aggregation kernel, and the new routes --------

PA_KINDS = ("sum", "count", "min", "max")


def _preagg_case(dev, case, W, rows, seed):
    """(W, R) int32 keys spread over all 32 bits (EMPTY rows included) and
    float32 values with -0.0 and ±inf."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if case == "uniform":
        k = torch.randint(0, 1000, (rows,), generator=g, device=dev)
    elif case == "hot":
        k = torch.randint(0, rows // 10, (rows,), generator=g, device=dev)
        k[torch.rand(rows, generator=g, device=dev) < 0.5] = 7
    else:
        k = torch.randperm(rows, generator=g, device=dev)
    k = (k * 2654435761) & 0xFFFFFFFF
    k[torch.rand(rows, generator=g, device=dev) < 0.05] = 0xFFFFFFFF
    keys = torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32).reshape(W, -1)
    vals = torch.randn(rows, generator=g, device=dev)
    vals[:7] = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"), -1.5, 2.5, -0.0])
    return keys, vals.reshape(W, -1)


def _assert_preagg_match(got, want, keys, vals, kind, capacity):
    """Table keys, spill mask and cnts equal; COUNT / MIN / MAX vals equal,
    SUM within 1e-4 of Σ|v| over the rows each slot folded."""
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert torch.equal(a, b)
    if kind != "sum":
        assert torch.equal(got[1], want[1])
        return
    fold = (keys != -1) & ~want[3]
    w = torch.arange(keys.shape[0], device=keys.device)[:, None].expand_as(keys)
    at = (w * capacity + slot_hash(keys, capacity))[fold]
    absum = torch.zeros(keys.shape[0] * capacity, dtype=torch.float64, device=keys.device)
    absum.index_add_(0, at, vals[fold].double().abs())
    a, b = got[1].reshape(-1), want[1].reshape(-1)
    d = (a - b).abs().double()
    # a slot that folded ±inf holds the same non-finite sum on both sides
    assert bool(((a == b) | (a.isnan() & b.isnan()) | (d <= 1e-4 * absum + 1e-6)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("morsel", [None, 1024])
@pytest.mark.parametrize("C", [64, 1024, 16384])
@pytest.mark.parametrize("W", [8, 132])
@pytest.mark.parametrize("case", ["uniform", "hot", "unique"])
def test_preagg_kernel_matches_plain(cuda, case, W, C, morsel):
    # C = 16384 takes 256 KiB of tables: the global-memory path
    keys, vals = _preagg_case(cuda, case, W, W * 2048, 81 + W + C)
    for kind in PA_KINDS:
        before = pa.preagg.launches
        got = pa.preagg(keys, vals, kind=kind, capacity=C, morsel=morsel)
        want = pa.preagg_plain(keys, vals, kind=kind, capacity=C, morsel=morsel)
        torch.cuda.synchronize()
        assert pa.preagg.launches == before + 1
        _assert_preagg_match(got, want, keys, vals, kind, C)


@pytest.mark.gpu
@pytest.mark.parametrize("case,W,R,C", [
    ("odd_rows", 3, 1001, 1024),         # worker bases off 16 bytes: ragged quads
    ("many_tiles", 1, (1 << 20) + 3, 1024),  # one worker over hundreds of tiles
    ("under_one_tile", 4, 100, 64),
    ("c16", 8, 4096, 16),
    ("c8192", 8, 8192, 8192),            # the last shared-memory size
    ("one_key", 8, 4096, 1024),
    ("empty_worker", 4, 3000, 1024),
    ("offset_view", 2, 5000, 1024),      # keys and values 4 bytes past 16-byte alignment
])
def test_preagg_kernel_tiles_match_plain(cuda, case, W, R, C):
    g = torch.Generator(device=cuda).manual_seed(R + C)
    keys, vals = _preagg_case(cuda, "hot" if case == "many_tiles" else "uniform", W, W * R,
                              97 + W)
    if case == "one_key":
        keys = torch.full_like(keys, 123456789)
    elif case == "empty_worker":
        keys[1] = -1
    elif case == "offset_view":
        kk = torch.randint(-2**31, 2**31 - 1, (W * R + 1,), generator=g, device=cuda,
                           dtype=torch.int64).to(torch.int32) % 3001
        vv = torch.randn(W * R + 1, generator=g, device=cuda)
        keys, vals = kk[1:].view(W, R), vv[1:].view(W, R)
        assert keys.data_ptr() % 16 == 4
    for kind in PA_KINDS:
        before = pa.preagg.launches
        got = pa.preagg(keys, vals, kind=kind, capacity=C)
        want = pa.preagg_plain(keys, vals, kind=kind, capacity=C)
        torch.cuda.synchronize()
        assert pa.preagg.launches == before + 1
        _assert_preagg_match(got, want, keys, vals, kind, C)
    if case == "many_tiles":
        assert pa.launch.grid[0] > 100
    if case == "empty_worker":
        assert bool((got[0][1] == -1).all()) and not bool(got[3][1].any())


@pytest.mark.gpu
def test_preagg_kernel_edges(cuda):
    keys = torch.full((8, 0), -1, dtype=torch.int32, device=cuda)
    tk_, tv, tc, sp = pa.preagg(keys, None, kind="count", capacity=64)
    torch.cuda.synchronize()
    assert bool((tk_ == -1).all()) and bool((tc == 0).all()) and sp.shape == (8, 0)
    keys = (torch.arange(3000, device=cuda, dtype=torch.int32) % 5).reshape(1, -1)
    got = pa.preagg(keys, None, kind="count", capacity=16)  # values unread for count
    want = pa.preagg_plain(keys, None, kind="count", capacity=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2].sum()) + int(got[3].sum()) == 3000  # every row folded or spilled
    with pytest.raises(ValueError, match="power of 2"):
        pa.preagg(keys, None, kind="count", capacity=48)
    with pytest.raises(ValueError, match="multiple of morsel"):
        pa.preagg(keys, None, kind="count", capacity=16, morsel=7)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["partitioned", "partitioned_grow", "sort", "spill",
                                   "spill_auto"])
def test_new_routes_on_the_card(cuda, route):
    from repro_torch.engine import spill as tsp

    rows = 1 << 18
    g = torch.Generator(device=cuda).manual_seed(91)
    card = 20000 if route in ("partitioned_grow", "spill", "spill_auto") else 1000
    keys = torch.randint(0, card, (rows,), generator=g, device=cuda) * 2654435761 & 0xFFFFFFFF
    vals = torch.randn(rows, generator=g, device=cuda)
    if route.startswith("partitioned"):
        aggs = (api.AggSpec("max", "v"),)
        plan = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="partitioned",
                               max_groups=1024 if route == "partitioned" else 256,
                               saturation="raise" if route == "partitioned" else "grow",
                               raw_keys=True)
    elif route == "sort":
        aggs = (api.AggSpec("count"), api.AggSpec("max", "v"))
        plan = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent",
                               max_groups=1024, raw_keys=True,
                               execution=api.ExecutionPolicy(ticketing="sort",
                                                             kernel="scan_body"))
    else:
        aggs = (api.AggSpec("count"), api.AggSpec("max", "v"))
        plan = api.GroupByPlan(keys=("k",), aggs=aggs,
                               strategy="auto" if route == "spill_auto" else "concurrent",
                               max_groups=None if route == "spill_auto" else 2048,
                               saturation="spill", raw_keys=True,
                               execution=api.ExecutionPolicy(
                                   kernel=None if route == "spill_auto" else "scan_body"))
    p0, s0, t0 = pa.preagg.launches, sa.segment_agg.launches, fk.scan_ticket.launches
    handle = plan.stream([api.Table({"k": keys[i:i + 65536], "v": vals[i:i + 65536]})
                          for i in range(0, rows, 65536)])
    out = handle.result()
    torch.cuda.synchronize()
    if route.startswith("partitioned"):
        assert pa.preagg.launches - p0 >= 4 and sa.segment_agg.launches == s0
        assert fk.scan_ticket.launches == t0
    elif route == "sort":
        assert handle.peak_buffered_chunks == 4 and pa.preagg.launches == p0
        assert sa.segment_agg.launches > s0
    else:
        ex = handle.executor
        inner = getattr(ex, "_inner", ex)
        assert isinstance(inner, tsp.SpillExecutor)
        assert sa.segment_agg.launches > s0 and fk.scan_ticket.launches > t0
        st = handle.stats()
        assert st["spilled_rows"] > 0 and st["device_groups"] <= inner._budget
        assert st["peak_device_table_bytes"] <= 2 * st["residency_bytes"]
        assert inner._op.migrations == 0
    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    mx = torch.full((uk.numel(),), float("-inf"), device=cuda).scatter_reduce_(
        0, inv, vals, "amax")
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["max(v)"][:n][order], mx)
    if "count(*)" in out.columns:
        assert torch.equal(out["count(*)"][:n][order].long(), cnt)


# -- the serving layer's batched ticket launch ------------------------------------------


def _batched_lanes(cuda, n_lanes, rows, seed, cards=(1000, 30000, 300), bound=None):
    """``n_lanes`` lanes of ``rows`` keys in 4096-row morsels, each against
    its own carried table: capacities cycle over 3 sizes, and every fourth
    lane was migrated to twice its capacity after a first chunk.  Returns
    (keys (N, npm, M), [(table, threshold, bound_slack)])."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    km = torch.stack([
        torch.randint(0, cards[i % len(cards)], (rows,), generator=gen, device=cuda,
                      dtype=torch.int32).reshape(-1, 4096)
        for i in range(n_lanes)])
    km[:, 0, :100] = -1  # EMPTY rows
    lanes = []
    for i in range(n_lanes):
        g = bound or cards[i % len(cards)] + 64
        table = tk.make_table(table_capacity(g) << (i % 3), g, device=cuda)
        if i % 4 == 3:
            first = km[i, :2].contiguous()
            fk.scan_ticket(table, first, torch.ones(2, dtype=torch.int32, device=cuda),
                           threshold=table.capacity // 2)
            table = tops.migrate(table, 2 * table.capacity)  # the migration kernel
        lanes.append((table, table.capacity // 2, g - 4096))
    return km, lanes


def _batched_pair(km, lanes, **kw):
    """scan_ticket_batched and its plain version on copies of the same
    lanes: ((tickets, tables, todo, info) each)."""
    out = []
    for fn in (fk.scan_ticket_batched, fk.scan_ticket_batched_plain):
        tables = [tk.TicketTable(*(x.clone() for x in t)) for t, _, _ in lanes]
        todo = torch.ones(km.shape[:2], dtype=torch.int32, device=km.device)
        tickets, info = fn(tables, km, todo, thresholds=[th for _, th, _ in lanes],
                           bound_slacks=[b for _, _, b in lanes], **kw)
        out.append((tickets, tables, todo, info))
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n_lanes", [5, 40])
def test_scan_ticket_batched_matches_plain(cuda, n_lanes):
    """Lanes of different capacities (one in four migrated to 2C) in one
    round; 40 lanes cross the 32-lane cap and take two launches.  Each
    lane keeps scan_ticket's contract with the plain version."""
    km, lanes = _batched_lanes(cuda, n_lanes, 16 * 4096, 71)
    before = fk.scan_ticket_batched.launches
    (kt, ktab, ktodo, kinfo), (pt, ptab, ptodo, pinfo) = _batched_pair(km, lanes)
    assert fk.scan_ticket_batched.launches - before == -(-n_lanes // fk.MAX_BATCH_LANES)
    assert torch.equal(kinfo, pinfo) and not bool(ktodo.any())
    for i in range(n_lanes):
        assert fk.scan_ticket_discrepancies(km[i], (kt[i], ktab[i]), (pt[i], ptab[i])) == 0, i
        assert bool(ktab[i].overflowed) == bool(ptab[i].overflowed)


@pytest.mark.gpu
def test_scan_ticket_batched_raise_round_with_one_overflowing_lane(cuda):
    """Under RAISE, exactly one lane issues more tickets than its G: only
    its info row shows a count past G and only its overflow flag is set,
    while every lane commits every morsel."""
    km, lanes = _batched_lanes(cuda, 6, 8 * 4096, 72, cards=(500,), bound=1024)
    km[2] = torch.arange(km[2].numel(), device=cuda, dtype=torch.int32).reshape(km[2].shape) % 3000
    big = tk.make_table(8192, 1024, device=cuda)  # room for 3000 keys: no pause
    lanes[2] = (big, big.capacity // 2, 1024 - 4096)
    (kt, ktab, ktodo, kinfo), (pt, ptab, _, pinfo) = _batched_pair(km, lanes)
    assert torch.equal(kinfo, pinfo) and not bool(ktodo.any())
    over = kinfo[:, fk.INFO_COUNT] > 1024
    assert over.tolist() == [i == 2 for i in range(6)]
    assert [bool(t.overflowed) for t in ktab] == over.tolist()
    for i in range(6):
        assert fk.scan_ticket_discrepancies(km[i], (kt[i], ktab[i]), (pt[i], ptab[i])) == 0, i


@pytest.mark.gpu
def test_scan_ticket_batched_failed_launch_raises_and_never_falls_back(cuda, monkeypatch,
                                                                        tmp_path):
    km, lanes = _batched_lanes(cuda, 3, 2 * 4096, 73)
    tables = [t for t, _, _ in lanes]
    copies = [tk.TicketTable(*(x.clone() for x in t)) for t in tables]
    todo = torch.ones(km.shape[:2], dtype=torch.int32, device=cuda)
    kw = dict(thresholds=[th for _, th, _ in lanes], bound_slacks=[b for _, _, b in lanes])
    before = fk.scan_ticket_batched.launches
    monkeypatch.setattr(fk, "SCAN_BLOCK_THREADS", 96)  # no kernel of that size
    with pytest.raises(RuntimeError, match="scan_ticket_batched kernel launch failed"):
        fk.scan_ticket_batched(tables, km, todo, **kw)
    monkeypatch.undo()

    def no_nvcc():
        raise RuntimeError("nvcc not found (forced by the test)")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="forced by the test"):
        fk.scan_ticket_batched(tables, km, todo, **kw)
    torch.cuda.synchronize()
    assert fk.scan_ticket_batched.launches == before and bool(todo.all())
    for t, c in zip(tables, copies):  # nothing ran, on the card or on the host
        assert all(torch.equal(a, b) for a, b in zip(t, c))


@pytest.mark.gpu
def test_serve_on_the_card_batched_matches_solo(cuda):
    """Six queries on the default device through AggregationServer: the
    batched rounds launch scan_ticket_batched and fewer scan_ticket
    launches than solo stepping, and every query's map equals its solo
    run's and its sequential collect's."""
    from repro_torch.serve import AggregationServer

    gen = torch.Generator(device=cuda).manual_seed(74)
    rows, chunk = 1 << 16, 1 << 14
    data = [(torch.randint(0, 1000, (rows,), generator=gen, device=cuda, dtype=torch.int32),
             torch.randn(rows, generator=gen, device=cuda)) for _ in range(6)]
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("sum", "v"),
                                              api.AggSpec("max", "v")),
                           strategy="concurrent", max_groups=1024, raw_keys=True,
                           execution=api.ExecutionPolicy(morsel_rows=4096))

    def chunks(k, v):
        return [api.Table({"k": k[i:i + chunk], "v": v[i:i + chunk]})
                for i in range(0, rows, chunk)]

    runs = {}
    for batched in (True, False):
        b0, s0 = fk.scan_ticket_batched.launches, fk.scan_ticket.launches
        server = AggregationServer(slots=6, batch_queries=batched)
        handles = [server.submit(plan, chunks(k, v)) for k, v in data]
        server.run_until_idle()
        runs[batched] = ([h.result() for h in handles],
                         fk.scan_ticket_batched.launches - b0, fk.scan_ticket.launches - s0)
    assert runs[True][1] > 0 and runs[False][1] == 0
    assert runs[True][2] < runs[False][2]
    for (k, v), got, solo in zip(data, runs[True][0], runs[False][0]):
        want = plan.collect(chunks(k, v))
        for out in (got, solo):
            n = int(out["__num_groups__"][0])
            order = torch.argsort(out["key"][:n])
            wn = int(want["__num_groups__"][0])
            worder = torch.argsort(want["key"][:wn])
            assert n == wn and torch.equal(out["key"][:n][order], want["key"][:wn][worder])
            for col in ("count(*)", "max(v)"):
                assert torch.equal(out[col][:n][order], want[col][:wn][worder]), col
            tol = 1e-4 * torch.zeros(n, device=cuda).index_add_(
                0, torch.searchsorted(out["key"][:n][order], k.long()), v.abs())
            assert bool(((out["sum(v)"][:n][order] - want["sum(v)"][:wn][worder]).abs()
                         <= tol).all())


# -- the folding round: ticket and update in one launch ------------------------------

_FOLD_KINDS = ("sum", "count", "min", "max")


def _fold_specs(S):
    """S deduplicated (column, kind) specs over ceil(S / 4) value columns."""
    return tuple((f"v{j // 4}", _FOLD_KINDS[j % 4]) for j in range(S))


def _fold_pair(km, lanes, vals, specs, todo=None, **kw):
    """Fold mode of scan_ticket_batched and its plain version on copies of
    the same lanes, each into fresh accumulators: (tables, states, todo,
    info) each, kernel first.  ``vals`` (N, npm, M, V)."""
    from repro_torch.core import updates as up

    out = []
    for fn in (fk.scan_ticket_batched, fk.scan_ticket_batched_plain):
        tables = [tk.TicketTable(*(x.clone() for x in t)) for t, _, _ in lanes]
        states = [up.init_agg_state(specs, t.max_groups, device=km.device) for t in tables]
        values = [{f"v{c}": vals[i, :, :, c].contiguous() for c in range(vals.shape[3])}
                  for i in range(km.shape[0])]
        lane_todo = (torch.ones(km.shape[:2], dtype=torch.int32, device=km.device)
                     if todo is None else todo.clone())
        tickets, info = fn(tables, list(km), lane_todo, thresholds=[th for _, th, _ in lanes],
                           bound_slacks=[b for _, _, b in lanes], states=states, values=values,
                           specs=specs, **kw)
        assert tickets is None
        out.append((tables, states, lane_todo, info))
    torch.cuda.synchronize()
    return out


def _assert_fold_map(keys, vals, table, state, specs, rows=None):
    """One lane's table and planes against an oracle over its rows (all,
    or the morsels of ``rows``): gap-free tickets naming their slots'
    keys, and per ticket below G its key's COUNT / MIN / MAX exact and
    SUM within 1e-4 of its Σ|v| (a fold of exactly that key's rows)."""
    if rows is not None:
        keys, vals = keys[rows], vals[rows]
    keys, vals = keys.reshape(-1), vals.reshape(-1, vals.shape[-1])
    live = keys != -1
    keys, vals = keys[live].long() & 0xFFFFFFFF, vals[live]
    n, g = int(table.count), table.max_groups
    t = table.tickets[table.tickets > 0]
    assert torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32))
    kb = table.key_by_ticket[:min(n, g)].long() & 0xFFFFFFFF
    uk, inv = torch.unique(keys, return_inverse=True)
    idx = torch.searchsorted(uk, kb)
    assert bool((idx < uk.numel()).all()) and torch.equal(uk[idx.clamp(max=uk.numel() - 1)], kb)
    if rows is None:
        assert uk.numel() == n
    for (col, kind), acc in zip(specs, state.accs):
        v = vals[:, int(col[1:])]
        got = acc[:min(n, g)]
        if kind == "count":
            want = torch.zeros(uk.numel(), device=v.device).index_add_(0, inv, torch.ones_like(v))
        elif kind == "sum":
            want = torch.zeros(uk.numel(), dtype=torch.float64, device=v.device).index_add_(
                0, inv, v.double())
            scale = torch.zeros_like(want).index_add_(0, inv, v.double().abs())
            assert bool(((got.double() - want[idx]).abs() <= 1e-4 * scale[idx]).all()), col
            continue
        else:
            want = torch.full((uk.numel(),), float("inf" if kind == "min" else "-inf"),
                              device=v.device).scatter_reduce_(
                0, inv, v, "amin" if kind == "min" else "amax")
        assert torch.equal(got, want[idx]), (col, kind)
        neutral = {"count": 0.0, "min": float("inf"), "max": float("-inf")}[kind]
        assert bool((acc[min(n, g):] == neutral).all()), (col, kind)


def _fold_lanes(cuda, n_lanes, S, cards, seed, rows=16 * 4096):
    km, lanes = _batched_lanes(cuda, n_lanes, rows, seed, cards=cards)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    vals = torch.randn((*km.shape, -(-S // 4)), generator=gen, device=cuda)
    return km, lanes, vals


@pytest.mark.gpu
@pytest.mark.parametrize("n_lanes,S,cards", [
    (3, 1, (1000, 30000, 300)),   # device atomics (G up to 30064)
    (3, 16, (1000,)),             # device atomics (16 × 1064 floats past the shared cap)
    (16, 4, (1000,)),             # serve_low's shape: the shared (S, G) plane
    (16, 16, (300,)),             # the shared plane at S = 16
    (32, 16, (300, 1000)),        # 32 lanes × 16 planes in one launch's parameters
    (33, 1, (1000, 300)),         # two launches
])
def test_scan_ticket_batched_fold_matches_plain(cuda, n_lanes, S, cards):
    """Fold mode against its plain version as maps: per lane the same info
    row, the same count and key set, and every plane's fold of its keys'
    rows (COUNT / MIN / MAX exact, SUM within 1e-4·Σ|v|), in
    ⌈N / 32⌉ launches."""
    km, lanes, vals = _fold_lanes(cuda, n_lanes, S, cards, 81 + n_lanes + S)
    specs = _fold_specs(S)
    before = fk.scan_ticket_batched.launches
    (ktab, kst, ktodo, kinfo), (ptab, pst, _, pinfo) = _fold_pair(km, lanes, vals, specs)
    assert fk.scan_ticket_batched.launches - before == -(-n_lanes // fk.MAX_BATCH_LANES)
    assert torch.equal(kinfo, pinfo) and not bool(ktodo.any())
    for i in range(n_lanes):
        _assert_fold_map(km[i], vals[i], ktab[i], kst[i], specs)
        _assert_fold_map(km[i], vals[i], ptab[i], pst[i], specs)
        n = int(ktab[i].count)
        assert torch.equal(torch.sort(ktab[i].key_by_ticket[:n]).values,
                           torch.sort(ptab[i].key_by_ticket[:n]).values), i


@pytest.mark.gpu
def test_scan_ticket_batched_fold_saturating_lane_folds_nothing_then_replays(cuda):
    """Checked, no pause (threshold past C): lane 1 brings 3000 keys to a
    2048-slot table, so the morsels that meet a full table saturate.  Each
    of them folds nothing and stays todo (its inserts stay); the morsels
    that commit fold exactly their rows.  Migrating the table to 8192
    slots and running the todo morsels again (what ``poll`` does) gives
    the whole chunk's map; the other lanes are untouched by it."""
    km, lanes, vals = _fold_lanes(cuda, 3, 4, (500,), 91)
    km[1] = (torch.arange(km[1].numel(), device=cuda, dtype=torch.int32) % 3000).reshape(
        km[1].shape)[:, torch.randperm(4096, device=cuda)]
    t1 = tk.make_table(2048, 4096, device=cuda)
    lanes[1] = (t1, 1 << 30, 0)
    lanes = [(t, 1 << 30, b) for t, _, b in lanes]
    specs = _fold_specs(4)
    (ktab, kst, ktodo, kinfo), _ = _fold_pair(km, lanes, vals, specs)
    left = ktodo[1].bool()
    assert bool(left.any()) and not bool(ktodo[0].any() or ktodo[2].any())
    assert kinfo[1, fk.INFO_SAT] == 1 and kinfo[1, fk.INFO_HALTED] == 1
    assert kinfo[1, fk.INFO_FIRST_HALT] == int(left.nonzero()[0])
    committed = (~left).nonzero().reshape(-1)
    if committed.numel():
        # the committed morsels' rows alone: their keys' tickets stay, so
        # compare group by group over those rows only
        sub = tk.TicketTable(*(x.clone() for x in ktab[1]))
        _assert_fold_subset(km[1], vals[1], sub, kst[1], specs, committed)
    else:
        assert all(bool((a == a[0]).all()) for a in kst[1].accs)
    for i in (0, 2):
        _assert_fold_map(km[i], vals[i], ktab[i], kst[i], specs)
    ktab[1] = tops.migrate(ktab[1], 8192)  # the migration kernel's layout
    todo = ktodo[1:2].clone()
    values = [{"v0": vals[1, :, :, 0].contiguous()}]
    _, info = fk.scan_ticket_batched([ktab[1]], [km[1]], todo, thresholds=[1 << 30],
                                     bound_slacks=[0], states=[kst[1]], values=values,
                                     specs=specs)
    torch.cuda.synchronize()
    assert not bool(todo.any()) and info[0, fk.INFO_HALTED] == 0
    _assert_fold_map(km[1], vals[1], ktab[1], kst[1], specs)


def _assert_fold_subset(keys, vals, table, state, specs, morsels):
    """The planes hold the fold of exactly the rows of ``morsels``: each
    ticket's key, over those rows only (keys that only the saturated
    morsels brought keep neutral planes)."""
    rows = keys[morsels].reshape(-1)
    rv = vals[morsels].reshape(-1, vals.shape[-1])
    live = rows != -1
    rows, rv = rows[live].long(), rv[live]
    n = min(int(table.count), table.max_groups)
    kb = table.key_by_ticket[:n].long()
    for (col, kind), acc in zip(specs, state.accs):
        v = rv[:, int(col[1:])]
        hit = rows[None, :] == kb[:, None]          # (n, rows): a few MB at most
        if kind == "count":
            want = hit.sum(1).float()
            assert torch.equal(acc[:n], want), kind
        elif kind == "sum":
            want = (hit * v.double()[None, :]).sum(1)
            scale = (hit * v.double().abs()[None, :]).sum(1)
            assert bool(((acc[:n].double() - want).abs() <= 1e-4 * scale).all()), kind
        else:
            fill = float("inf") if kind == "min" else float("-inf")
            masked = torch.where(hit, v[None, :], torch.full_like(v[None, :], fill))
            want = masked.amin(1) if kind == "min" else masked.amax(1)
            assert torch.equal(acc[:n], want), kind


@pytest.mark.gpu
def test_scan_ticket_batched_fold_raise_round_with_one_lane_past_g(cuda):
    """RAISE: lane 2 takes 3000 keys against G = 1024 in a table with room
    (no pause).  Every morsel commits; only lane 2's count passes G and
    only its overflow flag is set; its tickets past G fold nothing, and
    every ticket below G holds its key's whole fold."""
    km, lanes, vals = _fold_lanes(cuda, 6, 4, (500,), 92, rows=8 * 4096)
    lanes = [(tk.make_table(table_capacity(1024), 1024, device=cuda), 1024, 1024 - 4096)
             for _ in range(6)]
    km[2] = (torch.arange(km[2].numel(), device=cuda, dtype=torch.int32) % 3000).reshape(
        km[2].shape)
    lanes[2] = (tk.make_table(8192, 1024, device=cuda), 4096, 1024 - 4096)
    specs = _fold_specs(4)
    (ktab, kst, ktodo, kinfo), (ptab, pst, _, pinfo) = _fold_pair(km, lanes, vals, specs)
    assert torch.equal(kinfo, pinfo) and not bool(ktodo.any())
    over = (kinfo[:, fk.INFO_COUNT] > 1024).tolist()
    assert over == [i == 2 for i in range(6)]
    assert [bool(t.overflowed) for t in ktab] == over == [bool(t.overflowed) for t in ptab]
    for i in range(6):
        _assert_fold_map(km[i], vals[i], ktab[i], kst[i], specs)


@pytest.mark.gpu
def test_scan_ticket_batched_fold_unchecked_round(cuda):
    """Unchecked: lane 0's 1024-slot table meets 4096 keys, so rows not
    placed in C probes fold nothing, and every morsel still commits; the
    placed keys hold their whole folds, and the other lanes match the
    plain version."""
    km, lanes, vals = _fold_lanes(cuda, 4, 4, (700,), 93, rows=4 * 4096)
    km[0] = torch.randperm(km[0].numel(), device=cuda).to(torch.int32).reshape(
        km[0].shape) % 4096
    lanes[0] = (tk.make_table(1024, 4096, device=cuda), 512, 0)
    specs = _fold_specs(4)
    (ktab, kst, ktodo, kinfo), (ptab, pst, _, pinfo) = _fold_pair(km, lanes, vals, specs,
                                                                   checked=False)
    assert not bool(ktodo.any()) and int(ktab[0].count) == 1024
    assert torch.equal(kinfo[1:], pinfo[1:]) and kinfo[0, fk.INFO_HALTED] == 0
    _assert_fold_subset(km[0], vals[0], ktab[0], kst[0], specs,
                        torch.arange(km.shape[1], device=cuda))
    for i in range(1, 4):
        _assert_fold_map(km[i], vals[i], ktab[i], kst[i], specs)


@pytest.mark.gpu
def test_scan_ticket_batched_fold_failed_launch_leaves_every_lane(cuda, monkeypatch):
    """A launch that cannot run (no kernel of 96 threads) raises before
    any lane changes: every table, accumulator and todo row stays as it
    was, across the 33 lanes of two launches, and nothing runs on the
    host instead."""
    from repro_torch.core import updates as up

    km, lanes, vals = _fold_lanes(cuda, 33, 4, (1000,), 94, rows=2 * 4096)
    specs = _fold_specs(4)
    tables = [t for t, _, _ in lanes]
    states = [up.init_agg_state(specs, t.max_groups, device=cuda) for t in tables]
    copies = [tk.TicketTable(*(x.clone() for x in t)) for t in tables]
    accs = [[a.clone() for a in s.accs] for s in states]
    todo = torch.ones(km.shape[:2], dtype=torch.int32, device=cuda)
    before = fk.scan_ticket_batched.launches
    monkeypatch.setattr(fk, "SCAN_BLOCK_THREADS", 96)
    with pytest.raises(RuntimeError, match="scan_ticket_batched kernel launch failed"):
        fk.scan_ticket_batched(tables, list(km), todo, thresholds=[th for _, th, _ in lanes],
                               bound_slacks=[b for _, _, b in lanes], states=states,
                               values=[{"v0": vals[i, :, :, 0].contiguous()} for i in range(33)],
                               specs=specs)
    torch.cuda.synchronize()
    assert fk.scan_ticket_batched.launches == before and bool(todo.all())
    for t, c, s, a in zip(tables, copies, states, accs):
        assert all(torch.equal(x, y) for x, y in zip(t, c))
        assert all(torch.equal(x, y) for x, y in zip(s.accs, a))


@pytest.mark.gpu
def test_serve_fold_rounds_on_the_card(cuda, monkeypatch):
    """consume_batched on the card with the scatter update: each round is
    one ``scan_ticket_batched`` launch and no ``update_planes`` call,
    except the replays of a lane whose 2048-slot table saturates (3000
    keys under G = 4096): its ``poll`` migrates and replays alone.  Every
    query's result holds its whole chunk stream's map."""
    import importlib

    from repro_torch.engine import executors as tex

    gb = importlib.import_module("repro_torch.engine.groupby")
    updates = []
    real = gb.GroupByOperator.update_planes

    def counted(self, *a, **kw):
        updates.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(gb.GroupByOperator, "update_planes", counted)
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("sum", "v"),
                                              api.AggSpec("min", "v"), api.AggSpec("max", "v")),
                           strategy="concurrent", max_groups=4096, raw_keys=True,
                           execution=api.ExecutionPolicy(morsel_rows=4096, capacity=2048))
    gen = torch.Generator(device=cuda).manual_seed(95)
    rows, chunk = 1 << 15, 1 << 14
    keys = [torch.randint(0, 1000, (rows,), generator=gen, device=cuda, dtype=torch.int32)
            for _ in range(4)]
    keys[1] = torch.randperm(rows, generator=gen, device=cuda).to(torch.int32) % 3000
    vals = [torch.randn(rows, generator=gen, device=cuda) for _ in range(4)]
    xs = [tex.make_executor(plan) for _ in range(4)]
    for x in xs:
        x.open()
    before = fk.scan_ticket_batched.launches
    for lo in range(0, rows, chunk):
        tex.consume_batched(xs, [api.Table({"k": k[lo:lo + chunk], "v": v[lo:lo + chunk]})
                                 for k, v in zip(keys, vals)])
    assert fk.scan_ticket_batched.launches - before == rows // chunk
    assert updates and all(u is xs[1]._op for u in updates)
    for x, k, v in zip(xs, keys, vals):
        out = x.finalize()
        n = int(out["__num_groups__"][0])
        uk, inv, cnt = torch.unique(k.long(), return_inverse=True, return_counts=True)
        order = torch.argsort(out["key"][:n])
        assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
        assert torch.equal(out["count(*)"][:n][order].long(), cnt)
        for kind in ("min", "max"):
            want = torch.full((n,), float("inf" if kind == "min" else "-inf"),
                              device=cuda).scatter_reduce_(0, inv, v, "a" + kind)
            assert torch.equal(out[f"{kind}(v)"][:n][order], want), kind
        s = torch.zeros(n, dtype=torch.float64, device=cuda).index_add_(0, inv, v.double())
        a = torch.zeros(n, dtype=torch.float64, device=cuda).index_add_(0, inv, v.double().abs())
        assert bool(((out["sum(v)"][:n][order].double() - s).abs() <= 1e-4 * a).all())


# -- stream checkpoints ----------------------------------------------------------------


def _ckpt_stream(cuda, rows=1 << 18, chunk=1 << 15, card=3000, seed=97):
    g = torch.Generator(device=cuda).manual_seed(seed)
    keys = torch.randint(0, card, (rows,), generator=g, device=cuda, dtype=torch.int32)
    vals = torch.randint(0, 100, (rows,), generator=g, device=cuda).float()

    def chunks(device):
        return [api.Table({"k": keys[i:i + chunk].to(device), "v": vals[i:i + chunk].to(device)})
                for i in range(0, rows, chunk)]

    return keys, vals, chunks


def _exact_map(out, keys, vals):
    """Integer-valued f32 values: SUM and COUNT exact against torch.unique."""
    keys = keys.to(out["key"].device).long()
    vals = vals.to(out["key"].device).double()
    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    s = torch.zeros(uk.numel(), dtype=torch.float64, device=uk.device).index_add_(0, inv, vals)
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)
    assert torch.equal(out["sum(v)"][:n][order].double(), s)


@pytest.mark.gpu
def test_card_commit_restores_on_the_cpu_and_back(cuda, tmp_path):
    """A scan_body stream saved on the card restores into a ``device="cpu"``
    plan (the plain versions) and finishes with the oracle's map; a CPU
    commit restores onto the card the same way."""
    keys, vals, chunks = _ckpt_stream(cuda)
    aggs = (api.AggSpec("count"), api.AggSpec("sum", "v"))

    def plan(device):
        return api.GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent",
                               max_groups=1 << 10, saturation="grow", raw_keys=True,
                               execution=api.ExecutionPolicy(kernel="scan_body",
                                                             device=device))

    for saver, loader in (("cuda", "cpu"), ("cpu", "cuda")):
        h = plan(saver).stream(chunks(saver))
        h.pump(3)
        path = str(tmp_path / saver)
        h.save(path)
        _exact_map(h.result(), keys, vals)
        restored = plan(loader).restore(path, chunks(loader))
        assert restored.chunks_consumed == 3
        assert restored.executor._op._table.keys.device.type == loader
        _exact_map(restored.result(), keys, vals)


@pytest.mark.gpu
def test_restored_default_plan_takes_the_cuda_route(cuda, tmp_path):
    """A default plan restored on the card runs scan_body + scatter, as its
    resolution did (``executors.cuda_route``): the kernels launch after the
    restore, and the map is the oracle's."""
    keys, vals, chunks = _ckpt_stream(cuda)
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("sum", "v")),
                           raw_keys=True)
    h = plan.stream(chunks("cuda"))
    h.pump(4)
    resolved = h.executor._resolved.execution
    assert (resolved.kernel, resolved.update) == ("scan_body", "scatter")
    h.save(str(tmp_path))
    restored = plan.restore(str(tmp_path), chunks("cuda"))
    r = restored.executor._resolved.execution
    assert (r.kernel, r.update) == ("scan_body", "scatter")
    assert restored.executor._inner._op.use_kernel
    t0, s0 = fk.scan_ticket.launches, sa.segment_agg.launches
    out = restored.result()
    torch.cuda.synchronize()
    assert fk.scan_ticket.launches > t0 and sa.segment_agg.launches > s0
    _exact_map(out, keys, vals)


# ---------------------------------------------------------------------------
# multi-device sharding: the card as a mesh of virtual members


def _sharded_plan(mesh, merge, sat, max_groups=1 << 12, **ex):
    return api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"), api.AggSpec("sum", "v")),
                           strategy="sharded", max_groups=max_groups, saturation=sat,
                           raw_keys=True,
                           execution=api.ExecutionPolicy(mesh=mesh, shard_merge=merge, **ex))


@pytest.fixture
def card_mesh(cuda):
    from repro_torch.parallel import sharding

    sharding.virtual_devices(4, cuda)
    yield sharding.make_mesh((4,), ("data",))
    sharding.reset_virtual_devices()


@pytest.mark.gpu
@pytest.mark.parametrize("merge,sat", [(m, s) for m in ("dense_psum", "all_to_all")
                                       for s in ("raise", "grow", "unchecked")])
def test_sharded_plans_on_the_card(card_mesh, merge, sat):
    """Four members on one card: every member's step is one ``scan_ticket``
    launch and one segment launch per plane, the dense_psum union is one
    ticket launch, the fused kernel never runs, and the map is the
    oracle's (GROW from a bound of 64 grows every member and the union)."""
    keys, vals, chunks = _ckpt_stream(torch.device("cuda"))
    before = {f: getattr(m, f).launches for m, f in ((fk, "scan_ticket"), (sa, "segment_agg"),
                                                     (th, "ticket_hash"), (fk, "fused_consume"))}
    h = _sharded_plan(card_mesh, merge, sat, 64 if sat == "grow" else 1 << 12).stream(
        chunks("cuda"))
    out = h.result()
    torch.cuda.synchronize()
    d = {f: getattr(m, f).launches - before[f] for m, f in (
        (fk, "scan_ticket"), (sa, "segment_agg"), (th, "ticket_hash"), (fk, "fused_consume"))}
    _exact_map(out, keys, vals)
    n_chunks = len(chunks("cpu"))
    if sat == "grow":
        assert h.executor.bound_grows >= 1 and d["scan_ticket"] >= 4 * n_chunks
    else:
        assert d["scan_ticket"] == 4 * n_chunks
        assert d["segment_agg"] == 4 * n_chunks * 2 + (4 * 2 if merge == "dense_psum" else 0)
    assert (d["ticket_hash"] >= 1) == (merge == "dense_psum") and d["fused_consume"] == 0


@pytest.mark.gpu
def test_sharded_remesh_and_cross_count_restore_on_the_card(card_mesh, tmp_path):
    """Two of four members fail mid-stream: the survivors' re-bucketed
    tables (built by the ticket kernel) probe back to their tickets and the
    stream ends on the oracle's map; a commit saved on 4 members restores
    on 2 and on the CPU."""
    from repro_torch.engine import elastic as tel
    from repro_torch.parallel import sharding
    from repro_torch.train import elastic as telastic

    keys, vals, chunks = _ckpt_stream(torch.device("cuda"))
    h = _sharded_plan(card_mesh, "dense_psum", "raise").stream(chunks("cuda"))
    h.pump(3)
    telastic.mark_failed([2, 3])
    try:
        assert tel.remesh_stream(h)
    finally:
        telastic.reset_failures()
    for t in h.executor._carry.tables:
        c = int(t.count)
        assert torch.equal(tk.lookup(t, t.key_by_ticket[:c]),
                           torch.arange(c, dtype=torch.int32, device=t.keys.device))
    _exact_map(h.result(), keys, vals)
    assert h.executor.remeshes == 1 and h.executor._ndev == 2
    h = _sharded_plan(card_mesh, "all_to_all", "raise").stream(chunks("cuda"))
    h.pump(4)
    h.save(str(tmp_path))
    two = sharding.make_mesh((2,), ("data",))
    cpu = sharding.make_mesh((3,), ("data",), devices=[
        sharding.MeshDevice(i, torch.device("cpu")) for i in range(3)])
    for mesh, src in ((two, "cuda"), (cpu, "cpu")):
        restored = _sharded_plan(mesh, "all_to_all", "raise").restore(str(tmp_path),
                                                                       chunks(src))
        assert restored.chunks_consumed == 4
        _exact_map(restored.result(), keys, vals)


# -- the LM serving path: kernel B3 (grouped matmul) and the route histogram ------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,groups,k,n,empty,sizes,offset", [
    (64, 32, 1024, 512, 0, "routed", 0),      # granite-moe-1b-a400m decode: gate / up
    (64, 32, 512, 1024, 0, "routed", 0),      # and down
    (4096, 32, 1024, 512, 0, "routed", 0),    # a prefill-sized call
    (300, 16, 96, 70, 5, "routed", 0),        # empty groups, N % 4 != 0, rows past Σ sizes
    (312, 4, 1024, 512, 0, (3, 300, 0, 9), 0),  # a 300-row group: 64-row tiles, a partial one
    (4096, 32, 1024, 512, 0, "zipf", 0),      # Zipf-skewed groups, one of about half the rows
    (323, 32, 1000, 200, 0, "routed", 0),     # K and N off the 32-row K block and 64-column tile
    (1, 4, 512, 1024, 0, (0, 0, 1, 0), 0),    # M = 1
    (37, 4, 256, 192, 0, (0, 0, 0, 0), 0),    # every group empty, rows past them
    (70, 4, 1024, 512, 0, (5, 0, 17, 42), 1),  # lhs and rhs 4 bytes off a 16-byte boundary
])
def test_grouped_matmul_kernel_matches_plain(cuda, rows, groups, k, n, empty, sizes, offset):
    """B3 against its plain version (a loop of float32 torch.matmul with
    TF32 off): float32 sums in another order (3xTF32 products, per-stage
    partial sums), so within 1e-5 of the output's scale; the rows past
    Σ sizes exactly 0; one launch."""
    from repro_torch.kernels import grouped_matmul as gm

    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda).manual_seed(rows + n)

    def draw(*shape, scale=1.0):
        numel = int(np.prod(shape))
        flat = torch.randn(numel + offset, generator=g, device=cuda) * scale
        return flat[offset:].view(*shape)  # contiguous, `offset` floats off alignment

    lhs = draw(rows, k)
    rhs = draw(groups, k, n, scale=k ** -0.5)
    if sizes == "routed":
        ids = torch.randint(0, groups, (rows - 7 * bool(empty),), generator=g, device=cuda)
        ids = ids[ids >= empty]  # the first `empty` groups get no rows
        sizes = torch.bincount(ids, minlength=groups).to(torch.int32)
    elif sizes == "zipf":  # ∝ 1 / rank^1.7, the largest first: 2138 of 4096 rows
        w = 1.0 / np.arange(1, groups + 1) ** 1.7
        s = np.floor(rows * w / w.sum()).astype(np.int32)
        s[0] += rows - s.sum()
        sizes = torch.from_numpy(s[np.random.default_rng(rows).permutation(groups)]).to(cuda)
    else:
        sizes = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    assert (lhs.data_ptr() % 16 != 0) == bool(offset) and lhs.is_contiguous()
    before = gm.grouped_matmul.launches
    got = gm.grouped_matmul(lhs, rhs, sizes)
    torch.cuda.synchronize()
    assert gm.grouped_matmul.launches == before + 1
    want = gm.grouped_matmul_plain(lhs, rhs, sizes)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not got[int(sizes.sum()):].any()


@pytest.mark.gpu
def test_moe_layer_reaches_b3_and_the_segment_kernel(cuda):
    """One MoE layer of granite's full width on the card: 3 B3 launches and
    one segment launch (the route's GROUP BY COUNT, exact), and the output
    within 1e-4 of the same layer through the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe

    cfg = get_config("granite_moe_1b_a400m")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(g, cfg, cuda)
    x = torch.randn(8, 1, cfg.d_model, generator=g, device=cuda)
    b3, seg = gm.grouped_matmul.launches, sa.segment_agg.launches
    out, _ = moe.moe_mlp_dense(p, cfg, x)
    r = moe.route(p, cfg, x.reshape(-1, cfg.d_model))
    torch.cuda.synchronize()
    assert gm.grouped_matmul.launches - b3 == 3
    assert sa.segment_agg.launches - seg == 2
    onehot = torch.nn.functional.one_hot(r.experts.reshape(-1).long(), cfg.moe_experts_padded)
    assert torch.equal(r.histogram, onehot.sum(0).float())
    # the same layer through the plain versions
    x2 = x.reshape(-1, cfg.d_model)
    flat_e = r.experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    gtok = torch.arange(8, device=cuda).repeat_interleave(cfg.moe_top_k)[order]
    sizes = onehot.sum(0).to(torch.int32)
    gx = x2[gtok]
    h = torch.nn.functional.silu(gm.grouped_matmul_plain(gx, p["w_gate"], sizes)) \
        * gm.grouped_matmul_plain(gx, p["w_up"], sizes)
    yo = gm.grouped_matmul_plain(h, p["w_down"], sizes)
    want = torch.zeros_like(x2).index_add_(0, gtok, yo * r.weights.reshape(-1)[order][:, None])
    assert float((out.reshape(-1, cfg.d_model) - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
def test_grouped_matmul_gradient_on_the_card_launches_b6(cuda):
    """B3 is an autograd node on the card too: its backward launches kernel
    B6, one launch for each input whose gradient is needed, and the
    gradients hold to the plain backward; without grad B3 alone runs."""
    from repro_torch.kernels import grouped_matmul as gm

    g = torch.Generator(device=cuda).manual_seed(3)
    lhs = torch.randn(160, 96, generator=g, device=cuda)
    rhs = torch.randn(4, 96, 40, generator=g, device=cuda)
    sizes = torch.tensor([40, 0, 100, 11], dtype=torch.int32, device=cuda)
    ct = torch.randn(160, 40, generator=g, device=cuda)
    want = gm.grouped_matmul_backward_plain(lhs, rhs, sizes, ct)
    for need in ((True, True), (False, True), (True, False)):
        a = lhs.clone().requires_grad_(need[0])
        b = rhs.clone().requires_grad_(need[1])
        b3, b6 = gm.grouped_matmul.launches, gm.grouped_matmul_backward.launches
        out = gm.grouped_matmul(a, b, sizes)
        got = torch.autograd.grad(out, [t for t, n in zip((a, b), need) if n], ct)
        torch.cuda.synchronize()
        assert gm.grouped_matmul.launches - b3 == 1
        assert gm.grouped_matmul_backward.launches - b6 == sum(need)
        for x, y in zip(got, [w for w, n in zip(want, need) if n]):
            assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    before = gm.grouped_matmul.launches
    with torch.no_grad():
        out = gm.grouped_matmul(lhs.requires_grad_(True), rhs, sizes)
    torch.cuda.synchronize()
    assert gm.grouped_matmul.launches == before + 1 and out.grad_fn is None


# -- MoE training: kernel B6 (the grouped matmul's backward) -----------------------


def _b6_inputs(cuda, rows, groups, k, n, empty, sizes, offset, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def draw(*shape, scale=1.0):
        numel = int(np.prod(shape))
        flat = torch.randn(numel + offset, generator=g, device=cuda) * scale
        return flat[offset:].view(*shape)  # contiguous, `offset` floats off alignment

    if sizes == "routed":  # tokens routed top-8, the first `empty` groups without rows
        ids = torch.topk(torch.randn(rows // 8, groups - empty, generator=g, device=cuda), 8,
                         dim=-1).indices.reshape(-1) + empty
        sizes = torch.bincount(ids, minlength=groups).to(torch.int32)
    elif sizes == "zipf":  # a hot expert: about half the rows on one group
        import chip_smoke

        sizes = chip_smoke.zipf_sizes(rows, groups, g, cuda)
    else:
        sizes = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    m = max(rows, int(sizes.clamp(min=0).sum()))  # rows past the groups where rows > Σ sizes
    return draw(m, k), draw(groups, k, n, scale=k ** -0.5), sizes, draw(m, n)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,groups,k,n,empty,sizes,offset", [
    (64, 32, 1024, 512, 0, "routed", 0),       # granite-moe-1b-a400m decode: gate / up
    (64, 32, 512, 1024, 0, "routed", 0),       # and down
    (8192, 32, 1024, 512, 0, "routed", 0),     # granite's training step (8 × 128 tokens): gate / up
    (8192, 32, 512, 1024, 0, "routed", 0),     # and down
    (8192, 16, 128, 64, 8, "routed", 0),       # 8 of 16 groups empty (the reduced config's padding)
    (341, 4, 1024, 512, 0, (5, 0, 300, 17), 0),  # 19 rows past the groups, an empty group
    (323, 32, 1000, 200, 0, "routed", 0),      # a ragged K and N (off every tile)
    (200, 8, 96, 70, 0, "routed", 0),          # N % 4 != 0: the plain-load path of d_lhs
    (70, 4, 1024, 512, 0, (5, 0, 17, 42), 1),  # operands 4 bytes off a 16-byte boundary
    (37, 4, 256, 192, 0, (0, 0, 0, 0), 0),     # every group empty, every row past them
    (4000, 4, 512, 256, 0, (3, 3900, 0, 97), 0),  # one hot group
    (8192, 32, 1024, 512, 0, "zipf", 0),       # chip_smoke.zipf_sizes: a hot expert, half the rows
    (2048, 32, 1024, 512, 12, "routed", 0),    # 12 of 32 groups empty at granite's widths
    (2400, 32, 1000, 520, 0, "routed", 0),     # K and N off the 128-wide tiles
    (2000, 8, 1000, 520, 0, "routed", 1),      # all three 4 bytes off: the cp.async paths
    (1100, 4, 1024, 512, 0, (300, 0, 500, 200), 0),  # 100 rows past the last group
])
def test_grouped_matmul_backward_kernel_matches_plain(cuda, rows, groups, k, n, empty, sizes,
                                                      offset):
    """B6 against its plain version (a loop of float32 torch.matmul per
    group, TF32 off): both products in 3xTF32 on the tensor cores sum in
    another order, so each within 1e-5 of its max|plain|; d_lhs rows past
    the groups and d_rhs of empty groups exactly 0; two launches.  The
    launchers write into outputs filled with NaN, which must come out equal
    to the wrapper's: every element written."""
    from repro_torch.kernels import grouped_matmul as gm

    assert not torch.backends.cuda.matmul.allow_tf32
    lhs, rhs, sizes, ct = _b6_inputs(cuda, rows, groups, k, n, empty, sizes, offset, rows + n)
    assert (lhs.data_ptr() % 16 != 0) == bool(offset) and lhs.is_contiguous()
    before = gm.grouped_matmul_backward.launches
    d_lhs, d_rhs = gm.grouped_matmul_backward(lhs, rhs, sizes, ct)
    torch.cuda.synchronize()
    assert gm.grouped_matmul_backward.launches == before + 2
    w_lhs, w_rhs = gm.grouped_matmul_backward_plain(lhs, rhs, sizes, ct)
    for got, want in ((d_lhs, w_lhs), (d_rhs, w_rhs)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not d_lhs[int(sizes.clamp(min=0).sum()):].any()
    assert not d_rhs[sizes <= 0].any()
    n_lhs = torch.full_like(lhs, float("nan"))
    n_rhs = torch.full_like(rhs, float("nan"))
    gm._launch_dlhs(ct.contiguous(), rhs.contiguous(), sizes, n_lhs)
    gm._launch_drhs(lhs.contiguous(), ct.contiguous(), sizes, n_rhs)
    torch.cuda.synchronize()
    assert torch.equal(n_lhs, d_lhs) and torch.equal(n_rhs, d_rhs)


@pytest.mark.gpu
def test_grouped_matmul_backward_failed_build_raises(cuda, monkeypatch, tmp_path):
    """A B6 that cannot build raises, from the wrapper and from autograd's
    backward; nothing falls back to the plain backward."""
    from repro_torch.kernels import grouped_matmul as gm

    lhs = torch.randn(16, 32, device=cuda)
    rhs = torch.randn(4, 32, 8, device=cuda)
    sizes = torch.tensor([4, 4, 4, 4], dtype=torch.int32, device=cuda)
    ct = torch.randn(16, 8, device=cuda)
    out = gm.grouped_matmul(lhs.requires_grad_(True), rhs, sizes)  # B3 built beforehand

    def no_nvcc():
        raise RuntimeError("nvcc not found (forced by the test)")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    before = gm.grouped_matmul_backward.launches
    with pytest.raises(RuntimeError, match="forced by the test"):
        gm.grouped_matmul_backward(lhs.detach(), rhs, sizes, ct)
    with pytest.raises(RuntimeError, match="forced by the test"):
        torch.autograd.grad(out, [lhs], ct)
    assert gm.grouped_matmul_backward.launches == before


@pytest.mark.gpu
def test_moe_layer_gradients_on_b6_match_the_plain_backward(cuda):
    """One MoE layer of granite's full width on 8 × 16 tokens (1024 routed
    rows), differentiated at a fixed cotangent of its output and of the aux
    loss: through B3 / B6 (6 B6 launches) and through the plain versions,
    every leaf within 1e-5 of its max|grad|."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"), dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(g, cfg, cuda)
    x = torch.randn(8, 16, cfg.d_model, generator=g, device=cuda)
    ct = torch.randn(8, 16, cfg.d_model, generator=g, device=cuda)

    def grads():
        pm = {k: (v.detach().clone().requires_grad_(True) if torch.is_tensor(v) else
                  {kk: vv.detach().clone().requires_grad_(True) for kk, vv in v.items()})
              for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        out, aux = moe.moe_mlp_dense(pm, cfg, xx)
        leaves = [xx, pm["router"]["w"], pm["w_gate"], pm["w_up"], pm["w_down"]]
        return torch.autograd.grad((out, aux), leaves, (ct, torch.ones_like(aux)))

    before = gm.grouped_matmul_backward.launches
    got = grads()
    torch.cuda.synchronize()
    assert gm.grouped_matmul_backward.launches - before == 6
    kernels = moe.grouped_matmul, moe.segment_agg
    moe.grouped_matmul, moe.segment_agg = gm.grouped_matmul_plain, sa.segment_agg_plain
    try:
        want = grads()
    finally:
        moe.grouped_matmul, moe.segment_agg = kernels
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# -- LM training: kernel B5 (row segment sum) and the ticketed embedding's backward --


@pytest.mark.gpu
@pytest.mark.parametrize("rows,groups,d,hot", [
    (1024, 1024, 1024, 0.18),    # qwen3-0.6b: 8 × 128 ids, Zipf's token 0 share
    (3000, 64, 70, 0.5),         # d % 4 != 0: the scalar path; a hotter ticket
    (5, 3, 8, 0.0),
    (16384, 16384, 1024, 0.18),  # a batch of 8 × 2048 ids: several ticket ranges
    (3000, 512, 1024, 1.0),      # every row on one ticket
    (3000, 512, 1024, "dropped"),  # every ticket -1 or >= G: the output all 0
])
def test_segment_rows_kernel_matches_plain(cuda, rows, groups, d, hot):
    """B5 against its plain version (one index_add_): rows with tickets -1
    and >= G dropped; sums in atomic order, so within 1e-5 · Σ|row| of the
    ticket (a ticket with no row exactly 0)."""
    from repro_torch.kernels import segment_rows as sr

    g = torch.Generator(device=cuda).manual_seed(rows + d)
    t = torch.randint(-1, groups + 2, (rows,), generator=g, device=cuda, dtype=torch.int32)
    if hot == "dropped":
        t = torch.where(t < groups // 2, -1, groups + t % 3).to(torch.int32)
    else:
        t[torch.rand(rows, generator=g, device=cuda) < hot] = groups // 2
    x = torch.randn(rows, d, generator=g, device=cuda)
    before = sr.segment_rows.launches
    got = sr.segment_rows(x, t, groups)
    torch.cuda.synchronize()
    assert sr.segment_rows.launches == before + 1
    want = sr.segment_rows_plain(x, t, groups)
    scale = sr.segment_rows_plain(x.abs(), t, groups)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    # a row view that is not 16-byte aligned takes the scalar path
    got2 = sr.segment_rows(x.reshape(-1)[1:1 + rows * (d - 1)].reshape(rows, d - 1), t, groups)
    want2 = sr.segment_rows_plain(x.reshape(-1)[1:1 + rows * (d - 1)].reshape(rows, d - 1),
                                  t, groups)
    assert float((got2 - want2).abs().max()) <= 1e-5 * float(scale.max())


@pytest.mark.gpu
def test_segment_rows_writes_every_element(cuda):
    """Nothing zeroes B5's output first, so the kernel writes every
    element: the launcher the wrapper uses, into an output full of NaN,
    leaves no NaN, every ticket with no row reads exactly 0, and the sums
    hold to the plain version (R = G = 16384 at d 1024, several ticket
    ranges, the 16-byte path; d = 70, the scalar path)."""
    from repro_torch.kernels import segment_rows as sr

    g = torch.Generator(device=cuda).manual_seed(11)
    for rows, groups, d in ((16384, 16384, 1024), (3000, 512, 70)):
        t = torch.randint(-1, groups // 2, (rows,), generator=g, device=cuda, dtype=torch.int32)
        x = torch.randn(rows, d, generator=g, device=cuda)
        out = torch.full((groups, d), float("nan"), device=cuda)
        before = sr.segment_rows.launches
        sr._launch(x, t, out, groups)
        torch.cuda.synchronize()
        assert sr.segment_rows.launches == before + 1
        assert not bool(out.isnan().any())
        empty = torch.bincount(t[t >= 0].long(), minlength=groups) == 0
        assert int(empty.sum()) >= groups // 2 and not bool(out[empty].any())
        want = sr.segment_rows_plain(x, t, groups)
        scale = sr.segment_rows_plain(x.abs(), t, groups)
        assert bool(((out - want).abs() <= 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,vocab,d", [(8, 128, 151_936, 1024), (3, 100, 4096, 64)])
def test_ticketed_embed_backward_on_the_card_matches_the_cpu(cuda, b, s, vocab, d):
    """The ticketed embedding's backward on the card (the ticket kernel, B5,
    one index_add_: one launch of each kernel) against the same gradient on
    the CPU (their plain versions): the same rows touched, sums within
    1e-5 · Σ|g| of the id's rows."""
    from repro_torch.core.hashing import table_capacity
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.models import layers

    rng = np.random.default_rng(b * s)
    ids = ((rng.zipf(1.2, size=(b, s)) - 1) % vocab).astype(np.int32)
    mu = min(vocab, b * s)
    cap = table_capacity(mu)
    table = torch.randn(vocab, d, device=cuda) * d ** -0.5
    gg = torch.randn(b, s, d, device=cuda)
    tt = table.clone().requires_grad_(True)
    ids_c = torch.from_numpy(ids).to(cuda)
    t0, s0 = th.ticket_hash.launches, sr.segment_rows.launches
    (got,) = torch.autograd.grad(layers.ticketed_embed(tt, ids_c, mu, cap), tt, gg)
    torch.cuda.synchronize()
    assert th.ticket_hash.launches - t0 == 1 and sr.segment_rows.launches - s0 == 1
    tc = table.cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(layers.ticketed_embed(tc, torch.from_numpy(ids), mu, cap), tc,
                                  gg.cpu())
    absum = torch.zeros(vocab, d).index_add_(0, torch.from_numpy(ids).reshape(-1).long(),
                                             gg.cpu().reshape(-1, d).abs())
    got = got.cpu()
    assert torch.equal(got.abs().sum(1) > 0, want.abs().sum(1) > 0)
    assert bool(((got - want).abs() <= 1e-5 * absum).all())


@pytest.mark.gpu
def test_manual_dp_step_with_a_member_on_the_card_and_one_on_the_cpu(cuda):
    """``make_manual_dp_step`` over a (pod 1, data 2) mesh whose members sit
    on the CPU and on the card (reduced qwen3-0.6b, float32, ticketed
    embedding, three steps): each device keeps its own copy of the
    parameters and AdamW state, the two copies agree within float32
    rounding (1e-6), and the result equals the one-member step on the
    whole batch within lr and a median 1e-3 of it (grad_norm within rtol
    1e-5), the tolerances of tests/test_torch_dp.py."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3_0_6b", reduced=True), dtype="float32")
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=0, total_steps=50, ticketed_embedding=True)
    members = [sharding.MeshDevice(0, torch.device("cpu")),
               sharding.MeshDevice(1, torch.device("cuda", 0))]
    step = tloop.make_manual_dp_step(sharding.make_mesh((1, 2), ("pod", "data"), devices=members),
                                     cfg, hp)
    p_one = tf.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    params = tf.tree_map(lambda t: t.clone(), p_one)
    opt, o_one = adamw.init(params), adamw.init(p_one)
    one = tloop.make_train_step(cfg, hp)
    rng = np.random.default_rng(0)
    lrs = []
    t0 = th.ticket_hash.launches
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        params, opt, m = step(params, opt, batch)
        p_one, o_one, m1 = one(p_one, o_one, batch)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
        lrs.append(float(m1["lr"]))
    assert th.ticket_hash.launches - t0 == 3     # the card member's embedding backward
    diffs = []
    for leaf, want in zip(tf._leaves(params), tf._leaves(p_one)):
        whole = (0,) * leaf.ndim
        assert set(leaf.copies) == {("cpu", whole), ("cuda:0", whole)}
        on_cpu, on_card = leaf.copies[("cpu", whole)], leaf.copies[("cuda:0", whole)]
        assert on_card.device.type == "cuda"
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-6, atol=1e-6)
        diffs.append((on_cpu - want).abs().reshape(-1))
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= sum(lrs) and float(diffs.median()) <= 1e-3 * sum(lrs)
    for dev in ("cpu", "cuda:0"):
        assert int(opt.step.copies[(dev, ())]) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("token_slice,quantize", [(False, False), (True, False), (True, True)])
def test_expert_parallel_members_on_the_card(cuda, token_slice, quantize):
    """``moe_impl="ep"`` over a (data 2, model 2) mesh of virtual members of
    the card (reduced granite-moe-1b-a400m, float32, TF32 off, capacity 64:
    nothing drops): the forward's logits are the dense path's (B3 in
    float32) within 1e-5 of their max, or within 1e-3 under int8 dispatch
    (one code step); each member's experts are a view of the layer's stack
    on the card; the segment kernel launches once a member and layer
    (``route``), B3 not at all; a ``make_train_step`` step's loss is
    finite and its ticketed embedding backward launches the ticket kernel
    and B5 once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m", reduced=True), dtype="float32")
    params = tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    with sharding.virtual_devices(4) as members:
        mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=members)
    assert all(m.device.type == "cuda" for m in mesh.devices.reshape(-1))
    info = {"mesh": mesh, "dp": ("data",), "capacity_per_expert": 64,
            "token_slice": token_slice, "quantize_dispatch": quantize}
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    dense = tf.forward(params, cfg, batch, ticketed_embedding=False)
    seen, real = [], moe.moe_mlp_ep

    def spy(p_locals, *a, **kw):
        seen.append([p["w_gate"] for p in p_locals])
        return real(p_locals, *a, **kw)

    moe.moe_mlp_ep = spy
    s0, b0 = sa.segment_agg.launches, gm.grouped_matmul.launches
    try:
        ep = tf.forward(params, cfg, batch, ticketed_embedding=False, moe_impl="ep", ep_info=info)
    finally:
        moe.moe_mlp_ep = real
    torch.cuda.synchronize()
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert sa.segment_agg.launches - s0 == 4 * layers and gm.grouped_matmul.launches == b0
    rel = float((ep.logits - dense.logits).abs().max() / dense.logits.abs().max())
    assert rel <= (1e-3 if quantize else 1e-5), rel
    stack = params["layers"]["moe"]["w_gate"]
    for r, w in enumerate(seen[0]):
        assert w.device.type == "cuda"
        assert w.untyped_storage().data_ptr() == stack.untyped_storage().data_ptr()
        assert w.data_ptr() == stack[0, r * (cfg.moe_experts_padded // 2)].data_ptr()
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=0, total_steps=10, ticketed_embedding=True)
    t0, r0 = th.ticket_hash.launches, sr.segment_rows.launches
    _, _, m = tloop.make_train_step(cfg, hp, moe_impl="ep", ep_info=info)(
        params, adamw.init(params), batch)
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    assert th.ticket_hash.launches - t0 == 1 and sr.segment_rows.launches - r0 == 1
    sharding.reset_virtual_devices()


@pytest.mark.gpu
def test_counted_wrappers_still_launch_on_the_card(cuda):
    """The four wrappers the dry run counts by formula (``launch/roofline.py``
    ``counted``) launch their kernels on CUDA tensors and count each launch,
    with no dry run active and inside a ``CostMode`` (which then adds the
    kernels' formula FLOPs instead of their inner ops)."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.launch import dryrun

    g = torch.Generator(device=cuda).manual_seed(0)
    lhs = torch.randn(96, 64, generator=g, device=cuda)
    rhs = torch.randn(4, 64, 32, generator=g, device=cuda)
    sizes = torch.tensor([30, 0, 50, 16], dtype=torch.int32, device=cuda)
    cot = torch.randn(96, 32, generator=g, device=cuda)
    keys = torch.randint(0, 100, (2048,), generator=g, device=cuda, dtype=torch.int32)
    tickets = torch.randint(-1, 40, (256,), generator=g, device=cuda, dtype=torch.int32)
    vals = torch.randn(256, generator=g, device=cuda)
    rows = torch.randn(256, 16, generator=g, device=cuda)

    def calls():
        gm.grouped_matmul(lhs, rhs, sizes)
        gm.grouped_matmul_backward(lhs, rhs, sizes, cot)
        sa.segment_agg(tickets, vals, num_groups=40, kind="count", strategy="onehot",
                       morsel_size=1)
        th.ticket_hash(keys, capacity=256, max_groups=128)
        sr.segment_rows(rows, tickets, 40)

    counters = ((gm, "grouped_matmul", 1), (gm, "grouped_matmul_backward", 2),
                (sa, "segment_agg", 1), (th, "ticket_hash", 1), (sr, "segment_rows", 1))
    for mode in (None, dryrun.CostMode()):
        before = [getattr(mod, fn).launches for mod, fn, _ in counters]
        if mode is None:
            calls()
        else:
            with mode:
                calls()
        torch.cuda.synchronize()
        after = [getattr(mod, fn).launches for mod, fn, _ in counters]
        assert [a - b for a, b in zip(after, before)] == [n for _, _, n in counters]
    assert mode.flops == 3 * 2 * 96 * 64 * 32 + 256 + 256 * 16


@pytest.mark.gpu
def test_remat_gradients_with_b3_and_b6_under_recompute_on_the_card(cuda):
    """Reduced granite-moe-1b-a400m in float32 (TF32 off) on the card:
    ``lm_loss``'s gradients with every block rematerialised (B3 runs again
    in each block's recompute: 6 launches a MoE layer, B6 6, the segment
    kernel 2) against the blocks called directly (B3 3, B6 6, segment 1),
    every leaf within 1e-5 of its max|grad| (the MoE combine's
    ``index_add_`` adds in atomic order, so two runs differ in rounding)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m", reduced=True), dtype="float32")
    params = tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))

    def grads():
        counters = (gm.grouped_matmul, gm.grouped_matmul_backward, sa.segment_agg)
        before = [c.launches for c in counters]
        tree = tf.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tf.lm_loss(tree, cfg, batch)
        g = torch.autograd.grad(loss, list(tf._leaves(tree)))
        torch.cuda.synchronize()
        return g, [c.launches - b for c, b in zip(counters, before)]

    got, launched = grads()
    assert launched == [6 * layers, 6 * layers, 2 * layers]
    real = tf._remat
    tf._remat = lambda block, policy=None: block
    try:
        want, launched = grads()
    finally:
        tf._remat = real
    assert launched == [3 * layers, 6 * layers, layers]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# -- the table ops: GET_OR_INSERT into a carried table, lookup, migrate --------------

TABLE_CASES = {  # name → (distinct keys, capacity, G, rows)
    "low": (1000, 2048, 1024, 1 << 16),
    "high": (1 << 14, 1 << 16, 1 << 15, 1 << 17),
    "unique": (1 << 17, 1 << 19, 1 << 18, 1 << 17),
    "past_g": (3000, 8192, 1000, 1 << 15),
    "saturated": (5000, 1024, 8192, 1 << 14),
}


def _table_keys(cuda, case, seed):
    distinct, cap, g, rows = TABLE_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if case == "unique":
        keys = torch.randperm(1 << 24, generator=gen, device=cuda)[:rows]
    else:
        keys = torch.randint(0, distinct, (rows,), generator=gen, device=cuda)
    keys = ((keys * 2654435761) & 0xFFFFFFFF).to(torch.int64)
    keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)
    keys[torch.rand(rows, generator=gen, device=cuda) < 0.03] = -1  # EMPTY rows
    return keys, cap, g


def _no_sync(fn, *a):
    """``fn(*a)`` with any host sync on the card an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*a)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_sync_debug_mode_refuses_a_host_read(cuda):
    """The mode the table ops run under in these tests is live: a read of
    the card from the host raises."""
    t = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        _no_sync(lambda: int(t.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_ops_match_plain(cuda, case):
    """The three kernels against their plain versions on a carried table
    (its first half of the keys inserted by the plain version): the same
    map, count and flag for ``get_or_insert`` and ``migrate`` (the table
    ops' map check), ``lookup`` equal bit for bit, absent and EMPTY keys
    included, on a full table too; no host sync inside a wrapper."""
    keys, cap, g = _table_keys(cuda, case, 201)
    half = keys.shape[0] // 2
    _, base = tk.get_or_insert(tk.make_table(cap, g, device=cuda), keys[:half])
    known = int(base.count)
    ktab = tk.TicketTable(*(x.clone() for x in base))
    before = tops.get_or_insert.launches
    kt, same = _no_sync(tops.get_or_insert, ktab, keys)
    pt, ptab = tk.get_or_insert(base, keys)
    torch.cuda.synchronize()
    assert same is ktab and tops.get_or_insert.launches == before + 1
    full = case == "saturated"
    assert int(ktab.count) == int(ptab.count) and bool(ktab.overflowed) == bool(ptab.overflowed)
    assert tops.table_map_discrepancies(ktab, ptab, known=known, keys=keys, tickets=(kt, pt),
                                        full=full) == 0
    if full:
        assert int(ptab.count) == cap and bool((pt[keys != -1] < 0).any())
    if case == "past_g":
        assert int(ptab.count) > g and bool(ktab.overflowed)

    probe = torch.cat([keys, torch.tensor([-1, 0x7EADBEEF, 12345], dtype=torch.int32,
                                          device=cuda)])
    for table in (ptab, ktab):
        got = _no_sync(tops.lookup, table, probe)
        assert torch.equal(got, tk.lookup(table, probe))

    m_before = tops.migrate.launches
    km = _no_sync(tops.migrate, ktab, 2 * cap)
    pm = resize.migrate(ktab, 2 * cap)
    torch.cuda.synchronize()
    assert tops.migrate.launches == m_before + 1
    assert km.key_by_ticket is ktab.key_by_ticket and km.count is ktab.count
    assert tops.table_map_discrepancies(km, pm) == 0
    # the kernels that probe a table read what migrate wrote: every key it
    # holds is found, and none is inserted again
    held = torch.where(tk.lookup(pm, keys) >= 0, keys, -1)
    n = int(km.count)
    again, _ = _no_sync(tops.get_or_insert, km, held)
    assert int(km.count) == n and torch.equal(again, tk.lookup(pm, held))


@pytest.mark.gpu
def test_table_migrate_into_too_few_slots_raises(cuda):
    keys = torch.arange(100, dtype=torch.int32, device=cuda) * 7919
    _, t = tk.get_or_insert(tk.make_table(256, 128, device=cuda), keys)
    with pytest.raises(RuntimeError, match="do not fit 64 slots"):
        tops.migrate(t, 64)
    small = tops.migrate(t, 128)  # fewer slots, but the keys fit: no raise
    assert tops.table_map_discrepancies(small, resize.migrate(t, 128)) == 0


def _placed_past(table, homes, lo, hi):
    """How many keys homed in [homes[0], homes[1]) sit in slots [lo, hi)."""
    occ = torch.nonzero(table.tickets > 0).reshape(-1)
    home = slot_hash(table.keys[occ], table.capacity)
    return int(((home >= homes[0]) & (home < homes[1]) & (occ >= lo) & (occ < hi)).sum())


@pytest.mark.gpu
def test_table_ops_constants_match_the_library(cuda):
    lib = tops._library()
    assert lib.table_ops_tile_slots() == tops.MIGRATE_TILE_SLOTS
    assert tops.LOOKUP_SHARED_SLOTS <= lib.table_ops_max_shared_slots()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(tops.EDGE_CASES))
def test_table_ops_on_edge_tables(cuda, case):
    """The redesigned lookup and migration on ``table_ops.edge_case_table``
    (a cluster wrapping from C - 1 to 0, a full table, keys sharing a home
    8 slots before a tile's end, a table smaller than one tile, tables just
    under and over the shared-memory threshold), no host sync inside:
    every lookup path equals the plain version bit for bit, absent and
    EMPTY keys included; migrate at ratios 2, 4 and 16 gives 0 map
    discrepancies on the path the rule names (counted), and on the migrated
    table lookup and GET_OR_INSERT find every key and insert none."""
    table, probe = tops.edge_case_table(case, cuda)
    want = tk.lookup(table, probe)
    path = tops.lookup_path(table.capacity)
    assert path == ("probe" if case == "past_shared" else "shared")
    before = dict(tops.lookup.paths)
    assert torch.equal(_no_sync(tops.lookup, table, probe), want)
    assert tops.lookup.paths == {k: v + (k == path) for k, v in before.items()}
    for forced in ("shared", "probe"):
        if forced == "shared" and table.capacity > tops._library().table_ops_max_shared_slots():
            continue
        out = torch.empty_like(probe)
        _no_sync(tops._launch_lookup, table, probe, out, forced)
        assert torch.equal(out, want), forced
    c = table.capacity
    for ratio in tops.EDGE_RATIOS:
        c2 = ratio * c
        mpath = tops.migrate_path(c, c2)
        assert mpath == ("slot" if case == "small" else "tiled")
        before = dict(tops.migrate.paths)
        km = _no_sync(tops.migrate, table, c2)
        pm = resize.migrate(table, c2)
        torch.cuda.synchronize()
        assert tops.migrate.paths == {k: v + (k == mpath) for k, v in before.items()}
        assert tops.table_map_discrepancies(km, pm) == 0, (case, ratio)
        if case == "shared_home":  # a tile's share of the home ran into the next tile
            assert sum(_placed_past(km, (h, h + 1), h + 8, c2)
                       for h in range(4088, c2, c)) > 0, ratio
        if case == "wrap":  # the last tile's keys ran past slot C2 - 1 into slot 0 on
            assert _placed_past(km, (c2 - tops.MIGRATE_TILE_SLOTS, c2), 0, 64) > 0
        assert torch.equal(_no_sync(tops.lookup, km, probe), tk.lookup(pm, probe))
        held = torch.where(tk.lookup(pm, probe) >= 0, probe, -1)
        n = int(km.count)
        again, _ = _no_sync(tops.get_or_insert, km, held)
        assert int(km.count) == n and torch.equal(again, tk.lookup(pm, held))


@pytest.mark.gpu
def test_table_ops_failed_build_raises_and_never_falls_back(cuda, monkeypatch, tmp_path):
    keys = torch.arange(500, dtype=torch.int32, device=cuda)
    _, t = tk.get_or_insert(tk.make_table(1024, 512, device=cuda), keys)

    def no_nvcc():
        raise RuntimeError("nvcc not found (forced by the test)")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(tops, "_LIB", None)
    before = (tops.lookup.launches, tops.migrate.launches)
    for call in (lambda: tops.lookup(t, keys), lambda: tops.migrate(t, 2048)):
        with pytest.raises(RuntimeError, match="forced by the test"):
            call()
    assert (tops.lookup.launches, tops.migrate.launches) == before


TABLE_ROUTES = {  # name → (plan keywords, key cardinality, the table ops it must launch)
    "split": (dict(max_groups=2048, saturation="raise", execution=dict(kernel="split")), 1000,
              {"get_or_insert"}),
    "split_grow": (dict(max_groups=64, saturation="grow", execution=dict(kernel="split")),
                   3000, {"get_or_insert", "migrate"}),
    "partitioned": (dict(strategy="partitioned", max_groups=2048, saturation="raise"), 1000,
                    {"get_or_insert"}),
    "fused_p4": (dict(max_groups=2048, saturation="raise",
                      execution=dict(kernel="fused", kernel_programs=4)), 1000,
                 {"get_or_insert"}),
    "fused_grow": (dict(max_groups=64, saturation="grow", execution=dict(kernel="fused")),
                   3000, {"migrate"}),
    "scan_grow": (dict(max_groups=64, saturation="grow", execution=dict(kernel="scan_body")),
                  3000, {"migrate"}),
    "auto": (dict(strategy="auto"), 1 << 18, {"migrate"}),
    "host": (dict(max_groups=64, saturation="grow",
                  execution=dict(kernel="off", pipeline="host")), 3000,
             {"get_or_insert", "migrate"}),
    "hybrid": (dict(strategy="hybrid", max_groups=2048, saturation="raise"), 1000,
               {"get_or_insert", "lookup"}),
    "spill": (dict(max_groups=256, saturation="spill", execution=dict(kernel="scan_body")),
              3000, {"lookup"}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(TABLE_ROUTES))
def test_no_executor_site_reaches_the_plain_loops_on_the_card(cuda, monkeypatch, route):
    """With ``core.ticketing.get_or_insert`` / ``lookup`` and
    ``core.resize.migrate`` refusing CUDA tensors, every route still runs
    on the card: its merges, grows, lookups and migrations launch the
    table ops' kernels, and the result holds the oracle's map."""
    def refusing(fn):
        def call(table, *a, **k):
            if table.keys.is_cuda:
                raise AssertionError(f"{fn.__name__} reached with CUDA tensors")
            return fn(table, *a, **k)
        return call

    for mod, name in ((tk, "get_or_insert"), (tk, "lookup"), (resize, "migrate")):
        monkeypatch.setattr(mod, name, refusing(getattr(mod, name)))
    kw, card, wanted = TABLE_ROUTES[route]
    kw = dict(kw)
    rows = 1 << 18
    gen = torch.Generator(device=cuda).manual_seed(211)
    keys = torch.randint(0, card, (rows,), generator=gen, device=cuda)
    if route == "hybrid":
        keys[torch.rand(rows, generator=gen, device=cuda) < 0.3] = 7  # a heavy key
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"),), raw_keys=True,
                           execution=api.ExecutionPolicy(**kw.pop("execution", {})),
                           **dict({"strategy": "concurrent"}, **kw))
    before = {n: getattr(tops, n).launches for n in ("get_or_insert", "lookup", "migrate")}
    out = plan.stream([api.Table({"k": keys[i:i + 32768]})
                       for i in range(0, rows, 32768)]).result()
    torch.cuda.synchronize()
    launched = {n: getattr(tops, n).launches - b for n, b in before.items()}
    for name in wanted:
        assert launched[name] > 0, (route, launched)
    uk, cnt = torch.unique(keys, return_counts=True)
    n = int(out["__num_groups__"][0])
    order = torch.argsort(out["key"][:n])
    assert n == uk.numel() and torch.equal(out["key"][:n][order], uk)
    assert torch.equal(out["count(*)"][:n][order].long(), cnt)


@pytest.mark.gpu
def test_sharded_grow_migrates_on_the_card(card_mesh, monkeypatch):
    from repro_torch.core import distributed as dist
    monkeypatch.setattr(resize, "migrate", None)  # the plain loop is never reached
    carry = dist.make_sharded_carry(card_mesh, 64, ((None, "count"),), capacity=128)
    keys = torch.arange(60, dtype=torch.int32, device="cuda") * 101
    tables = tuple(tops.get_or_insert(t, keys)[1] for t in carry.tables)
    carry = carry._replace(tables=tables)
    before = tops.migrate.launches
    grown = dist.grow_sharded_carry(carry, 256, 512)
    assert tops.migrate.launches == before + 4
    for t in grown.tables:
        assert t.capacity == 512 and torch.equal(tk.lookup(t, keys),
                                                 torch.arange(60, dtype=torch.int32,
                                                              device="cuda"))
