"""The table ops of repro_torch (``kernels.table_ops``) vs the JAX reference.

The three wrappers, GET_OR_INSERT into a carried table, lookup and
migrate, run their plain versions on CPU tensors: those must equal
``repro.core.ticketing.get_or_insert`` / ``lookup`` and
``repro.core.resize.migrate`` bit for bit (uniform, zipf and unique keys,
EMPTY padding, a saturated table, tickets past G).  ``get_or_insert``
updates its table in place on every device.  ``table_map_discrepancies``,
the map check that holds the card kernels to these plain versions, gives
0 on a plain table whose slots are re-placed along valid probe chains and
more than 0 on each corruption of the map.  The executor sites of the
split, partitioned, P > 1 fused, grow, host, hybrid, spill and sharded
routes reach the table through these wrappers.  The kernels themselves
are held to the plain versions on a card, in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import resize as jresize
from repro.core import ticketing as jtk
from repro_torch.core import ticketing as tk
from repro_torch.core.hashing import slot_hash
from repro_torch.engine import plan_api as api
from repro_torch.kernels import table_ops as tops

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

EMPTY = 0xFFFFFFFF

# name → (rows of the first insert, rows of the second, key source, capacity, G)
CASES = {
    "uniform": (2048, 3000, "uniform", 2048, 1024),
    "zipf": (2048, 3000, "zipf", 4096, 2048),
    "unique": (1500, 1500, "unique", 8192, 4096),
    "saturated": (700, 2000, "wide", 1024, 2048),
    "past_g": (2048, 3000, "uniform", 2048, 300),
}


def _keys(source, n, rng, offset=0):
    if source in ("uniform", "wide"):
        k = rng.integers(0, 1000 if source == "uniform" else 5000, size=n)
    elif source == "zipf":
        k = (rng.zipf(1.5, size=n) - 1) % 5000
    else:
        k = rng.permutation(1 << 20)[:n] * 4093 + offset
    k = (k.astype(np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)
    k[rng.random(n) < 0.05] = EMPTY  # EMPTY padding rows
    return k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _to_port(jt):
    keys, tickets, kbt, count, ovf = (np.asarray(x) for x in jt)
    return tk.TicketTable(_t(keys), torch.from_numpy(tickets.copy()), _t(kbt),
                          torch.tensor(int(count), dtype=torch.int32), torch.tensor(bool(ovf)))


def _assert_same(jt, tt):
    keys, tickets, kbt, count, ovf = (np.asarray(x) for x in jt)
    assert np.array_equal(keys.view(np.int32), tt.keys.numpy())
    assert np.array_equal(tickets, tt.tickets.numpy())
    assert np.array_equal(kbt.view(np.int32), tt.key_by_ticket.numpy())
    assert int(count) == int(tt.count) and bool(ovf) == bool(tt.overflowed)


def _carried(case):
    """A JAX table after a first insert, the second batch of keys, and the
    port's copy of the table."""
    first, second, source, cap, g = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + first)
    _, jt = jtk.get_or_insert(jtk.make_table(cap, g), jnp.asarray(_keys(source, first, rng)))
    keys = _keys(source, second, rng, offset=1)
    return jt, keys, _to_port(jt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_get_or_insert_matches_the_reference_in_place(case):
    jt, keys, tt = _carried(case)
    jtix, jt2 = jtk.get_or_insert(jt, jnp.asarray(keys))
    ttix, tt2 = tops.get_or_insert(tt, _t(keys))
    assert tt2 is tt  # updated in place
    assert np.array_equal(np.asarray(jtix), ttix.numpy())
    _assert_same(jt2, tt)
    if case == "saturated":
        assert int(tt.count) == tt.capacity and bool((ttix < 0).any())
    if case == "past_g":
        assert int(tt.count) > tt.max_groups and bool(tt.overflowed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_matches_the_reference(case):
    jt, keys, tt = _carried(case)
    _, jt = jtk.get_or_insert(jt, jnp.asarray(keys))
    tt = _to_port(jt)
    got = tops.lookup(tt, _t(keys))
    if int(tt.count) < tt.capacity:
        absent = np.array([12345, 0xDEADBEEF, EMPTY], np.uint32)
        probe = np.concatenate([keys, absent])
        want = np.asarray(jtk.lookup(jt, jnp.asarray(probe)))
        assert np.array_equal(want, tops.lookup(tt, _t(probe)).numpy())
    else:
        # the reference's lookup loops forever on an absent key of a full
        # table (ROADMAP fault 1): present keys only, and the port's bound
        present = np.isin(keys, np.asarray(jt.keys)) & (keys != EMPTY)
        want = np.asarray(jtk.lookup(jt, jnp.asarray(keys[present])))
        assert np.array_equal(want, got.numpy()[present])
        assert bool((got[torch.from_numpy(~present)] == -1).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_migrate_matches_the_reference(case):
    jt, keys, _ = _carried(case)
    _, jt = jtk.get_or_insert(jt, jnp.asarray(keys))
    tt = _to_port(jt)
    for new_cap in (2 * tt.capacity, 4 * tt.capacity):
        got = tops.migrate(tt, new_cap)
        _assert_same(jresize.migrate(jt, new_cap), got)
        assert got.key_by_ticket is tt.key_by_ticket and got.count is tt.count
    with pytest.raises(ValueError, match="power of 2"):
        tops.migrate(tt, 3 * tt.capacity)


def _replaced(table, order):
    """``table`` with its (key, ticket) pairs inserted again in ``order``
    (indices into the occupied slots) by linear probing: another valid
    layout of the same map."""
    occ = (table.tickets > 0).numpy()
    keys, tickets = table.keys.numpy()[occ], table.tickets.numpy()[occ]
    c = table.capacity
    home = slot_hash(torch.from_numpy(keys), c).numpy()
    nk = np.full(c, -1, np.int32)
    nt = np.zeros(c, np.int32)
    for i in order:
        s = int(home[i])
        while nt[s]:
            s = (s + 1) & (c - 1)
        nk[s], nt[s] = keys[i], tickets[i]
    return tk.TicketTable(torch.from_numpy(nk), torch.from_numpy(nt), table.key_by_ticket,
                          table.count, table.overflowed)


def _plain_pair():
    """A carried table, the keys of a second insert, the plain result of
    that insert (tickets, table) and the count before it."""
    jt, keys, tt = _carried("uniform")
    known = int(tt.count)
    ref = tk.TicketTable(*(x.clone() for x in tt))
    tickets, ref = tk.get_or_insert(ref, _t(keys))
    return _t(keys), tickets, ref, known


def test_map_check_accepts_a_relayout_along_valid_probe_chains():
    keys, tickets, ref, known = _plain_pair()
    n = int((ref.tickets > 0).sum())
    for order in (np.arange(n)[::-1], np.random.default_rng(3).permutation(n)):
        other = _replaced(ref, order)
        assert not torch.equal(other.keys, ref.keys)  # another layout
        assert tops.table_map_discrepancies(other, ref, known=known, keys=keys,
                                            tickets=(tickets, tickets)) == 0
        assert tops.table_map_discrepancies(other, ref) == 0
        assert int(tops.unreachable_slots(other).sum()) == 0
    # new tickets renumbered among the new keys: still one valid map
    new = ref.tickets > known
    perm = torch.randperm(int(new.sum()), generator=torch.Generator().manual_seed(5))
    tick = ref.tickets.clone()
    tick[new] = ref.tickets[new][perm]
    kbt = ref.key_by_ticket.clone()
    kbt[(tick[new] - 1).long()] = ref.keys[new]
    other = tk.TicketTable(ref.keys, tick, kbt, ref.count, ref.overflowed)
    assert tops.table_map_discrepancies(other, ref, known=known, keys=keys,
                                        tickets=(tk.lookup(other, keys), tickets)) == 0


def _corrupt(ref, how):
    keys, tickets = ref.keys.clone(), ref.tickets.clone()
    kbt = ref.key_by_ticket.clone()
    occ = torch.nonzero(tickets > 0).reshape(-1)
    free = torch.nonzero(tickets == 0).reshape(-1)
    s = int(occ[len(occ) // 2])
    if how == "key_in_two_slots":
        f = int(free[0])
        keys[f], tickets[f] = keys[s], tickets[s]
    elif how == "changed_ticket":
        a, b = int(occ[1]), int(occ[2])
        tickets[a], tickets[b] = tickets[b], tickets[a]  # swapped: kbt no longer agrees
    elif how == "key_behind_empty":
        # move a key to the first free slot past its home's free slot
        home = int(slot_hash(keys[s:s + 1], ref.capacity))
        f = home
        while tickets[f] != 0:
            f = (f + 1) & (ref.capacity - 1)
        g = (f + 1) & (ref.capacity - 1)
        while tickets[g] != 0:
            g = (g + 1) & (ref.capacity - 1)
        keys[g], tickets[g] = keys[s], tickets[s]
        keys[s], tickets[s] = -1, 0
        # the moved key's old run is repaired by no one: only the hole counts
    elif how == "dropped_key":
        keys[s], tickets[s] = -1, 0
    return tk.TicketTable(keys, tickets, kbt, ref.count, ref.overflowed)


@pytest.mark.parametrize("how", ["key_in_two_slots", "changed_ticket", "key_behind_empty",
                                 "dropped_key"])
def test_map_check_counts_each_corruption(how):
    keys, tickets, ref, known = _plain_pair()
    bad = _corrupt(ref, how)
    assert tops.table_map_discrepancies(bad, ref, known=known) > 0
    assert tops.table_map_discrepancies(bad, ref) > 0
    if how == "key_behind_empty":
        assert int(tops.unreachable_slots(bad).sum()) >= 1


# -- the executor sites reach the table through the wrappers ------------------

ROUTES = {
    "split": (dict(max_groups=2048, saturation="raise",
                   execution=dict(kernel="split")), 1000, {"get_or_insert"}),
    "split_grow": (dict(max_groups=64, saturation="grow",
                        execution=dict(kernel="split")), 3000, {"get_or_insert", "migrate"}),
    "partitioned": (dict(strategy="partitioned", max_groups=2048, saturation="raise"), 1000,
                    {"get_or_insert"}),
    "fused_p4": (dict(max_groups=2048, saturation="raise",
                      execution=dict(kernel="fused", kernel_programs=4)), 1000,
                 {"get_or_insert"}),
    "fused_grow": (dict(max_groups=64, saturation="grow", execution=dict(kernel="fused")),
                   3000, {"migrate"}),
    "scan_grow": (dict(max_groups=64, saturation="grow", execution=dict(kernel="off")),
                  3000, {"migrate"}),
    "host": (dict(max_groups=64, saturation="grow",
                  execution=dict(kernel="off", pipeline="host")), 3000,
             {"get_or_insert", "migrate"}),
    "hybrid": (dict(strategy="hybrid", max_groups=2048, saturation="raise"), 1000,
               {"get_or_insert", "lookup"}),
    "spill": (dict(max_groups=256, saturation="spill", execution=dict(kernel="off")), 3000,
              {"lookup"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_executor_sites_reach_the_table_through_the_wrappers(route, monkeypatch):
    kw, card, wanted = ROUTES[route]
    calls = {name: 0 for name in ("get_or_insert", "lookup", "migrate")}
    for name in calls:
        real = getattr(tops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tops, name, counted)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, card, size=1 << 14).astype(np.int64)
    keys[rng.random(keys.size) < 0.3] = 7  # a heavy key for the hybrid route
    kw = dict(kw)
    execution = api.ExecutionPolicy(device="cpu", **kw.pop("execution", {}))
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"),),
                           raw_keys=True, execution=execution,
                           **dict({"strategy": "concurrent"}, **kw))
    out = plan.stream([api.Table({"k": torch.from_numpy(keys[i:i + 4096])})
                       for i in range(0, keys.size, 4096)]).result()
    uk, cnt = np.unique(keys, return_counts=True)
    n = int(out["__num_groups__"][0])
    order = np.argsort(out["key"][:n].numpy())
    assert n == uk.size and np.array_equal(out["key"][:n].numpy()[order], uk)
    assert np.array_equal(out["count(*)"][:n].numpy()[order].astype(np.int64), cnt)
    for name in wanted:
        assert calls[name] > 0, (route, name, calls)


def test_sharded_grow_migrates_through_the_wrapper(monkeypatch):
    from repro_torch.core import distributed as dist
    from repro_torch.parallel import sharding

    calls = []
    real = tops.migrate
    monkeypatch.setattr(tops, "migrate", lambda t, c: calls.append(c) or real(t, c))
    mesh = sharding.make_mesh((2,), ("data",), devices=[
        sharding.MeshDevice(i, torch.device("cpu")) for i in range(2)])
    carry = dist.make_sharded_carry(mesh, 64, ((None, "count"),), capacity=128)
    grown = dist.grow_sharded_carry(carry, 256, 512)
    assert calls == [512, 512] and all(t.capacity == 512 for t in grown.tables)
