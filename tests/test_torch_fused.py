"""The fused kernel module of repro_torch vs the JAX reference.

The plain ``fused_consume`` (the kernel's CPU path) must match JAX
``fused_consume(..., interpret=True)`` ticket for ticket: tkeys, ttks,
kbt, count, events and info exactly, accumulators within 1e-6 (relative
and absolute — the same float adds, possibly in another order).  The port
takes a per-morsel ``todo`` mask where JAX takes a resume morsel per
program; ``todo_from_start`` maps one onto the other.  The
host-side state helpers, ``core.ticketing`` and ``core.resize`` are held
against their JAX counterparts bit for bit.  The CUDA kernel itself is
held to the plain version on a card, in tests/test_torch_gpu.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import resize as jresize
from repro.core import ticketing as jtk
from repro.kernels import fused_groupby as jfk
from repro_torch.core import resize as tresize
from repro_torch.core import ticketing as ttk
from repro_torch.kernels import fused_groupby as tfk

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

ACC_TOL = 1e-6
SPECS4 = ((-1, "count"), (0, "sum"), (0, "min"), (0, "max"))


def _kinds(specs):
    return tuple(k for _, k in specs)


def _inputs(seed, P, npm, M, card, V=1, masked=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, card, size=(P * npm, M)).astype(np.int32)
    if masked:
        keys.reshape(-1)[rng.choice(keys.size, masked, replace=False)] = -1
    vals = rng.normal(size=(V, P * npm, M)).astype(np.float32)
    return keys, vals


def _run_both(jstate, keys, vals, start, specs, **kw):
    """One launch in each package from the same (JAX) state; the port's
    todo mask comes from ``start`` and must come back cleared for exactly
    the morsels before each program's first halt."""
    tstate = tfk.from_jax_state([np.asarray(a) for a in jstate])
    jnew, jinfo = jfk.fused_consume(
        jstate, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(start, jnp.int32),
        specs=specs, interpret=True, **kw,
    )
    P = len(start)
    npm = keys.shape[0] // P
    todo = tfk.todo_from_start(P, npm, start)
    tnew, tinfo = tfk.fused_consume(
        tstate, torch.from_numpy(keys), torch.from_numpy(vals), todo, specs=specs, **kw,
    )
    first = np.asarray(jinfo)[:, jfk.INFO_FIRST_HALT].clip(max=npm)
    assert torch.equal(todo, tfk.todo_from_start(P, npm, first))
    return jnew, np.asarray(jinfo), tnew, tinfo.numpy()


def _assert_state_equal(jstate, tstate):
    want = [np.asarray(a) for a in jstate]
    got = tfk.to_numpy(tstate)
    for name, w, g in zip(tfk.FusedState._fields, want, got):
        assert w.shape == g.shape and w.dtype == g.dtype, name
        if name == "accs":
            assert np.array_equal(np.isinf(w), np.isinf(g))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=ACC_TOL, atol=ACC_TOL)
        else:
            assert np.array_equal(w, g), name


MEAN4 = ((0, "sum"), (-1, "count"), (0, "min"), (0, "max"))  # mean → sum + count
P4_KW = dict(checked=True, grow_bound=False, threshold=512, collect_events=True)

CASES = {
    # name: (P, npm, M, card, capacity, max_groups, specs, start, kwargs)
    "fresh_unchecked": (1, 8, 512, 300, 1024, 512, ((0, "sum"),), (0,),
                        dict(checked=False, grow_bound=False, collect_events=True)),
    "programs_4_mean": (4, 3, 512, 400, 1024, 512, MEAN4, (0, 0, 0, 0), P4_KW),
    "count_only": (1, 6, 512, 250, 512, 256, ((-1, "count"),), (0,),
                   dict(checked=True, grow_bound=True, threshold=256,
                        bound_slack=0, collect_events=True)),
    "saturated_unchecked": (1, 4, 512, 300, 64, 256, SPECS4, (0,),
                            dict(checked=False, grow_bound=False, collect_events=True)),
    "saturated_checked": (1, 4, 512, 300, 128, 512, SPECS4, (0,),
                          dict(checked=True, grow_bound=False, threshold=1 << 20,
                               collect_events=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fused_consume_matches_jax(case):
    P, npm, M, card, cap, g, specs, start, kw = CASES[case]
    keys, vals = _inputs(sorted(CASES).index(case), P, npm, M, card, masked=37)
    jstate = jfk.init_fused_state(capacity=cap, max_groups=g, kinds=_kinds(specs),
                                  programs=P)
    jnew, jinfo, tnew, tinfo = _run_both(jstate, keys, vals, start, specs, **kw)
    assert np.array_equal(jinfo, tinfo)
    _assert_state_equal(jnew, tnew)
    if case.startswith("saturated"):
        assert tinfo[0, tfk.INFO_SAT] == 1


def test_resume_from_start_after_grow_matches_jax():
    """Checked with a pause partway through the chunk, then grow both
    states the same way and relaunch from the first halted morsel: the
    carried state crosses packages as numpy."""
    P, npm, M = 1, 8, 512
    keys, vals = _inputs(5, P, npm, M, 1500)
    kinds = _kinds(SPECS4)
    kw = dict(checked=True, grow_bound=True, collect_events=True)
    jstate = jfk.init_fused_state(capacity=2048, max_groups=1024, kinds=kinds)
    jmid, jinfo, tmid, tinfo = _run_both(
        jstate, keys, vals, (0,), SPECS4, threshold=1024, bound_slack=1024 - M, **kw
    )
    assert np.array_equal(jinfo, tinfo) and tinfo[0, tfk.INFO_HALTED] == 1
    first = int(tinfo[0, tfk.INFO_FIRST_HALT])
    assert 0 < first < npm
    jgrown = jfk.grow_fused_state(jmid, kinds, new_max_groups=4096, new_capacity=8192)
    tgrown = tfk.grow_fused_state(tmid, kinds, new_max_groups=4096, new_capacity=8192)
    _assert_state_equal(jgrown, tgrown)
    jend, jinfo2, tend, tinfo2 = _run_both(
        jgrown, keys, vals, (first,), SPECS4, threshold=4096, bound_slack=4096 - M, **kw
    )
    assert np.array_equal(jinfo2, tinfo2) and tinfo2[0, tfk.INFO_HALTED] == 0
    _assert_state_equal(jend, tend)
    # every valid row committed exactly once across the two launches
    assert int(tend.accs[0].sum()) == keys.size


@pytest.mark.parametrize("case", ["programs_4_mean", "saturated_checked", "count_only"])
def test_plain_todo_with_holes_equals_compacted_morsels(case):
    """A todo mask with holes runs exactly the flagged morsels in order:
    the same state, info and events as a launch over only those morsels
    (compacted, all todo), with the lowest-todo index mapped back."""
    P, npm, M, card, cap, g, specs, _, kw = CASES[case]
    npm *= 2
    keys, vals = _inputs(40 + sorted(CASES).index(case), P, npm, M, card, masked=11)
    rng = np.random.default_rng(7)
    flags = rng.random((P, npm)) < 0.6
    flags[:, 0] = True
    flags[:, -1] = False
    kinds = _kinds(specs)
    holes = tfk.init_fused_state(capacity=cap, max_groups=g, kinds=kinds, programs=P)
    packed = tfk.init_fused_state(capacity=cap, max_groups=g, kinds=kinds, programs=P)
    todo = torch.from_numpy(flags.reshape(-1).astype(np.int32))
    hnew, hinfo = tfk.fused_consume(holes, torch.from_numpy(keys), torch.from_numpy(vals),
                                    todo, specs=specs, **kw)
    n_sel = flags.sum(axis=1)
    width = int(n_sel.max())
    kp = np.full((P, width, M), -1, np.int32)
    vp = np.zeros((1, P, width, M), np.float32)
    for p in range(P):
        idx = np.flatnonzero(flags[p]) + p * npm
        kp[p, :n_sel[p]] = keys[idx]
        vp[0, p, :n_sel[p]] = vals[0, idx]
    ptodo = torch.from_numpy(
        (np.arange(width)[None, :] < n_sel[:, None]).reshape(-1).astype(np.int32))
    pnew, pinfo = tfk.fused_consume(packed, torch.from_numpy(kp.reshape(P * width, M)),
                                    torch.from_numpy(vp.reshape(1, P * width, M)), ptodo,
                                    specs=specs, **kw)
    for f in tfk.FusedState._fields:
        assert torch.equal(getattr(hnew, f), getattr(pnew, f)), f
    hi, pi = hinfo.numpy(), pinfo.numpy()
    cols = [tfk.INFO_COUNT, tfk.INFO_SAT, tfk.INFO_HALTED]
    assert np.array_equal(hi[:, cols], pi[:, cols])
    left = todo.reshape(P, npm).numpy()
    for p in range(P):
        idx = np.flatnonzero(flags[p])
        done = ptodo.reshape(P, width).numpy()[p, :n_sel[p]] == 0
        assert np.array_equal(left[p, idx], (~done).astype(np.int32))
        assert not left[p, ~flags[p]].any()  # holes stay holes
        low = pi[p, tfk.INFO_FIRST_HALT]
        want = tfk.NO_HALT if low == tfk.NO_HALT else idx[low]
        assert hi[p, tfk.INFO_FIRST_HALT] == want
    if case == "saturated_checked":
        assert hi[0, tfk.INFO_HALTED] == 1


def test_todo_from_start():
    todo = tfk.todo_from_start(3, 4, [0, 2, 4])
    assert todo.dtype == torch.int32 and todo.is_contiguous()
    assert todo.tolist() == [1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0]


def test_init_grow_merge_state_match_jax():
    """init, then grow and the second-level merge of a P = 4 state (the
    launch reuses the programs_4_mean configuration)."""
    P, npm, M, card, cap, g, specs, start, kw = CASES["programs_4_mean"]
    keys, vals = _inputs(99, P, npm, M, card)
    kinds = _kinds(specs)
    jstate = jfk.init_fused_state(capacity=cap, max_groups=g, kinds=kinds, programs=P)
    tstate = tfk.init_fused_state(capacity=cap, max_groups=g, kinds=kinds, programs=P)
    _assert_state_equal(jstate, tstate)
    jnew, _, tnew, _ = _run_both(jstate, keys, vals, start, specs, **kw)
    jg = jfk.grow_fused_state(jnew, kinds, new_max_groups=2 * g, new_capacity=4 * cap)
    before = [t.clone() for t in tnew]
    tg = tfk.grow_fused_state(tnew, kinds, new_max_groups=2 * g, new_capacity=4 * cap)
    _assert_state_equal(jg, tg)
    assert all(torch.equal(a, b) for a, b in zip(before, tnew))  # pure
    jt, jaccs = jfk.merge_fused_state(jnew, kinds)
    tt, taccs = tfk.merge_fused_state(tnew, kinds)
    for a, b in zip(jt[:4], tt[:4]):
        w = np.asarray(a)
        assert np.array_equal(w.view(np.int32) if w.dtype == np.uint32 else w, b.numpy())
    for a, b in zip(jaccs, taccs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=ACC_TOL, atol=ACC_TOL)


def test_single_program_merge_is_a_copy():
    kinds = ("sum",)
    st = tfk.init_fused_state(capacity=64, max_groups=32, kinds=kinds)
    table, accs = tfk.merge_fused_state(st, kinds)
    accs[0].fill_(5.0)
    table.key_by_ticket.fill_(3)
    assert float(st.accs.abs().sum()) == 0.0 and int(st.kbt[0, 0]) == -1


def _jax_table_np(t):
    return [np.asarray(x) for x in t]


def _to_t_table(np_table):
    keys, tickets, kbt, count, ovf = np_table
    return ttk.TicketTable(
        torch.from_numpy(keys.view(np.int32).copy()), torch.from_numpy(tickets.copy()),
        torch.from_numpy(kbt.view(np.int32).copy()), torch.tensor(int(count), dtype=torch.int32),
        torch.tensor(bool(ovf)),
    )


def _assert_table_equal(jt, tt):
    jn = _jax_table_np(jt)
    assert np.array_equal(jn[0].view(np.int32), tt.keys.numpy())
    assert np.array_equal(jn[1], tt.tickets.numpy())
    assert np.array_equal(jn[2].view(np.int32), tt.key_by_ticket.numpy())
    assert int(jn[3]) == int(tt.count) and bool(jn[4]) == bool(tt.overflowed)


@pytest.mark.parametrize("n,card,cap,g", [(2048, 300, 1024, 512), (1024, 500, 256, 128)])
def test_get_or_insert_bit_exact(n, card, cap, g):
    rng = np.random.default_rng(n + card)
    keys = rng.integers(0, card, size=n).astype(np.uint32)
    keys[:7] = 0xFFFFFFFF
    jt = jtk.make_table(cap, g)
    tt = ttk.make_table(cap, g)
    jtix, jt2, jplen = jtk.get_or_insert(jt, jnp.asarray(keys), count_probes=True)
    ttix, tt2, tplen = ttk.get_or_insert(tt, torch.from_numpy(keys.view(np.int32).copy()),
                                         count_probes=True)
    assert np.array_equal(np.asarray(jtix), ttix.numpy())
    assert np.array_equal(np.asarray(jplen), tplen.numpy())
    _assert_table_equal(jt2, tt2)
    assert int(tt.count) == 0  # pure
    if int(tt2.count) >= cap:
        return  # a full table has no empty slot to end an absent key's lookup
    probe = np.concatenate([keys[:300], np.array([card + 5, 0xFFFFFFFF], np.uint32)])
    assert np.array_equal(
        np.asarray(jtk.lookup(jt2, jnp.asarray(probe))),
        ttk.lookup(tt2, torch.from_numpy(probe.view(np.int32).copy())).numpy(),
    )


@pytest.mark.parametrize("new_cap", [4096])
def test_migrate_and_grow_bound_bit_exact(new_cap):
    rng = np.random.default_rng(new_cap)
    keys = rng.integers(0, 1 << 32, size=400, dtype=np.uint32)
    _, jt = jtk.get_or_insert(jtk.make_table(1024, 512), jnp.asarray(keys))
    tt = _to_t_table(_jax_table_np(jt))
    _assert_table_equal(jresize.migrate(jt, new_cap), tresize.migrate(tt, new_cap))
    _assert_table_equal(jresize.grow_bound(jt, 2048), tresize.grow_bound(tt, 2048))
    assert tresize.table_nbytes(tt) == jresize.table_nbytes(jt)


@pytest.mark.parametrize("kind", ["sum", "min"])
def test_fused_groupby_matches_pallas(kind):
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 300, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    jk, ja, jc = jfk.fused_groupby_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                          capacity=1024, max_groups=512, kind=kind,
                                          morsel_size=512)
    tk_, ta, tc = tfk.fused_groupby(torch.from_numpy(keys.astype(np.int64)),
                                    torch.from_numpy(vals), capacity=1024,
                                    max_groups=512, kind=kind, morsel_size=512)
    n = int(jc)
    assert n == int(tc)
    assert np.array_equal(np.asarray(jk)[:n].astype(np.int64), tk_.numpy()[:n])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=ACC_TOL, atol=ACC_TOL)


def test_state_round_trips_through_numpy():
    kinds = _kinds(SPECS4)
    js = jfk.init_fused_state(capacity=256, max_groups=128, kinds=kinds, programs=2)
    ts = tfk.from_jax_state([np.asarray(a) for a in js])
    back = tfk.to_numpy(ts)
    for a, b in zip(js, back):
        assert np.array_equal(np.asarray(a), b) and np.asarray(a).dtype == b.dtype


def test_wrapper_checks_inputs_and_devices():
    st = tfk.init_fused_state(capacity=64, max_groups=32, kinds=("sum",))
    keys = torch.zeros((2, 64), dtype=torch.int32)
    vals = torch.zeros((1, 2, 64))
    todo = torch.ones((2,), dtype=torch.int32)
    before = tfk.fused_consume.launches
    tfk.fused_consume(st, keys, vals, todo, specs=((0, "sum"),), checked=False)
    assert tfk.fused_consume.launches == before  # the plain path is no launch
    assert todo.tolist() == [0, 0]  # both morsels committed, in place
    with pytest.raises(TypeError):
        tfk.fused_consume(st, keys.long(), vals, todo, specs=((0, "sum"),))
    with pytest.raises(ValueError):
        tfk.fused_consume(st, keys, vals, todo, specs=((1, "sum"),))
    with pytest.raises(ValueError):
        tfk.fused_consume(st, keys[:, :32], vals, todo, specs=((0, "sum"),))
    with pytest.raises(ValueError):
        tfk.fused_consume(st, keys, vals, todo[:1], specs=((0, "sum"),))
    meta = tfk.FusedState(*(t.to("meta") for t in st))
    with pytest.raises(ValueError):
        tfk.fused_consume(meta, keys.to("meta"), vals.to("meta"), todo.to("meta"),
                          specs=((0, "sum"),))
