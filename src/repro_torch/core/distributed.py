"""Distributed group aggregation over a device mesh (paper "threads" ⇒ mesh
members).

Port of ``repro.core.distributed`` on the single-controller mesh of
``repro_torch.parallel.sharding``: one process drives every member, each
member's state is a set of tensors on its own device, and data moves
between members only through that module's collectives.

The streaming contract is the reference's.  Each member owns a carried
ticket table and its accumulator planes (:class:`ShardedCarry`); every
chunk is split contiguously over the members and each member folds its
slice into its own carry (:func:`make_sharded_consume_step`).  The
cross-member merge runs once, at finalize, over state that is O(members ×
capacity), independent of how many chunks streamed through:

* :func:`sharded_psum_merge` — the fully concurrent / thread-local merge:
  gather the members' unique-key lists, build ONE union table, scatter each
  member's partials into union-ticket order, reduce across members;
* :func:`sharded_exchange_merge` — the Leis baseline's exchange over the
  members' local aggregates: partition by key hash, ``all_to_all``, each
  owner finishes alone with sort ticketing.

Where each step runs.  A member's step is the scan route's ticket stage
(``kernels.fused_groupby.scan_ticket``: ``scan_ticket_kernel`` on a card,
its plain version — the reference's per-morsel body — on the CPU) and the
update of every accumulator plane over the step's ticket vector (the
segment kernel on a card, the named update of ``core/updates.py`` on the
CPU), whatever ``ExecutionPolicy.kernel`` says, as the reference's sharded
step ignores it too.  The union of :func:`sharded_psum_merge` and the fresh
tables of :func:`rebucket_sharded_carry` are built by the ticket kernel
(``kernels.ticket_hash``), their partials scattered by the segment kernel.

The reference replays the union on every device and relies on the replays
being identical; the ticket kernel claims slots with atomics, so two
builds would disagree on tickets.  The port builds the union once, on the
mesh's first member, and hands each member its slice of the union tickets.

Tables and accumulators are updated IN PLACE by a step (the port's
kernels write in place); :func:`grow_sharded_carry`,
:func:`rebucket_sharded_carry` and the merges return new tensors and leave
the carry as it was.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import resize
from repro_torch.core import ticketing as tk
from repro_torch.core import updates as up
from repro_torch.core.hashing import EMPTY_I32, partition_hash, table_capacity
from repro_torch.parallel import sharding

_MERGE_KIND = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}
_REDUCE = {"sum": sharding.psum, "min": sharding.pmin, "max": sharding.pmax}


def _members(mesh, axis: str = "data") -> list:
    """A mesh's members along ``axis``, or a sequence of members as given."""
    if isinstance(mesh, sharding.Mesh):
        return mesh.members(axis)
    return list(mesh)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def _update_fn(device: torch.device, update: str = "scatter"):
    """How a member folds a ticket vector into a plane: the segment kernel
    on a card (the CUDA route rule's scan_body / scatter), the named update
    of ``core/updates.py`` on the CPU."""
    if device.type == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.make_scan_update_fn(strategy="scatter")
    return up.get_update_fn(update)


# ---------------------------------------------------------------------------
# streaming sharded consume: per-member state carried ACROSS chunks


class ShardedCarry(NamedTuple):
    """Per-member streaming aggregation state: ``tables[i]`` and
    ``states[i]`` live on member i's device.

    ``tables[i]`` is member i's probe table and its ticket-ordered unique
    keys (``key_by_ticket``, the only thing the psum merge communicates);
    its ``overflowed`` flag is the member's sticky loss flag (tickets past
    the local bound, or rows a saturated table dropped).  ``states[i]``
    holds one ``(max_local,)`` accumulator per ``(column, kind)`` spec.
    Every member has the same ``max_local`` and ``capacity``: the grow rule
    and the commit format depend on it."""

    tables: tuple
    states: tuple

    @property
    def ndev(self) -> int:
        return len(self.tables)

    @property
    def capacity(self) -> int:
        return self.tables[0].capacity

    @property
    def max_local(self) -> int:
        return self.tables[0].max_groups

    @property
    def specs(self) -> tuple:
        return self.states[0].specs

    def stacked(self) -> dict:
        """Host copies in the reference's stacked ``(ndev, …)`` layout:
        ``keys`` / ``kbt`` uint32, ``tickets`` int32, ``count`` int32,
        ``ovf`` bool, and ``acc`` a tuple of float32 planes."""
        t = self.tables
        return {
            "keys": np.stack([_host(x.keys) for x in t]).view(np.uint32),
            "tickets": np.stack([_host(x.tickets) for x in t]),
            "kbt": np.stack([_host(x.key_by_ticket) for x in t]).view(np.uint32),
            "count": np.stack([_host(x.count).reshape(()) for x in t]).astype(np.int32),
            "ovf": np.stack([_host(x.overflowed).reshape(()) for x in t]).astype(np.bool_),
            "acc": tuple(np.stack([_host(s.accs[i]) for s in self.states])
                         for i in range(len(self.specs))),
        }

    @classmethod
    def from_stacked(cls, arrays: dict, specs, members) -> "ShardedCarry":
        """The inverse of :meth:`stacked`, member i's rows on member i's
        device (fresh contiguous tensors; keys keep their bits as int32)."""
        members = _members(members)

        def put(a, i, dtype):
            a = np.ascontiguousarray(np.asarray(a)[i])
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(a.copy()).to(members[i].device, dtype)

        tables, states = [], []
        for i in range(len(members)):
            tables.append(tk.TicketTable(
                put(arrays["keys"], i, torch.int32), put(arrays["tickets"], i, torch.int32),
                put(arrays["kbt"], i, torch.int32),
                put(arrays["count"], i, torch.int32).reshape(()),
                put(arrays["ovf"], i, torch.bool).reshape(()),
            ))
            states.append(up.AggState(tuple(specs), tuple(
                put(a, i, torch.float32) for a in arrays["acc"])))
        return cls(tuple(tables), tuple(states))

    def nbytes(self) -> int:
        return sum(resize.table_nbytes(t) for t in self.tables) + sum(
            a.numel() * a.element_size() for s in self.states for a in s.accs)


def make_sharded_carry(mesh, max_local: int, specs, capacity: int | None = None,
                       *, axis: str = "data") -> ShardedCarry:
    """Fresh state for every member of ``mesh`` (a mesh, or a sequence of
    members).  ``specs`` = [(column|None, kind), ...] as produced by
    ``engine.groupby.expand_agg_specs`` (mean already split into
    sum+count)."""
    specs = tuple(specs)
    cap = capacity or table_capacity(max_local)
    members = _members(mesh, axis)
    return ShardedCarry(
        tables=tuple(tk.make_table(cap, max_local, device=m.device) for m in members),
        states=tuple(up.init_agg_state(specs, max_local, device=m.device) for m in members),
    )


def make_sharded_consume_step(mesh, axis: str, *, update: str, load_factor: float,
                              checked: bool, collect_events: bool = False):
    """The per-chunk consume step: each member folds its ``(num_morsels,
    morsel_rows)`` slice of the chunk into its carried table and
    accumulators, from its own todo morsels.

    ``step(carry, km, vm, todo, events=None, only=None)`` → ``(carry,
    infos)``, or ``(carry, infos, events)`` with ``collect_events``.  ``km[i]`` is member
    i's ``(nm, M)`` int32 key morsels, ``vm[i]`` its ``{column: (nm, M)}``
    value planes and ``todo[i]`` its ``(nm,)`` int32 mask of morsels still
    to commit (``kernels.fused_groupby.todo_from_start(1, nm, start)`` is
    the reference's per-device ``start``), cleared in place for every
    morsel the step commits.  ``infos[i]`` is member i's ``(1, INFO_LEN)``
    control vector: count, lowest morsel still todo, saturation, halted
    (the reference's per-device halt flags).  ``events[i]`` is member i's
    ``(EVENT_VEC_LEN,)`` int32 event vector, which gains the step's counts
    in place.  ``only`` lists the members to launch (default: all; a
    member whose todo mask is empty still launches): the others keep
    their state, and their ``infos`` entry is ``None``.

    ``checked=True`` runs the pause protocol of the scan route (§4.4 at
    mesh scale): before each morsel a member pauses when its load factor or
    its bound headroom is crossed, and a paused or saturated morsel commits
    nothing, so the host can grow every member's table and resume each at
    its own todo morsels.  ``checked=False`` is the zero-sync regime: no
    pauses; rows past a full table drop, and the sticky ``overflowed``
    flag records the loss, read once at finalize by the raise policy."""
    from repro_torch.kernels import fused_groupby as fk

    members = _members(mesh, axis)
    update_fns = [_update_fn(m.device, update) for m in members]

    def step(carry: ShardedCarry, km, vm, todo, events=None, only=None):
        if len(carry.tables) != len(members):
            raise ValueError(f"a carry of {len(carry.tables)} members on a mesh of "
                             f"{len(members)}")
        states, infos = list(carry.states), [None] * len(members)
        for i in range(len(members)) if only is None else only:
            table, state = carry.tables[i], carry.states[i]
            live = None if checked else todo[i].bool()  # before the launch clears it
            tickets, info = fk.scan_ticket(
                table, km[i], todo[i], checked=checked, grow_bound=checked,
                threshold=int(load_factor * table.capacity),
                bound_slack=table.max_groups - km[i].shape[1],
                collect_events=collect_events,
                events=events[i] if collect_events else None,
            )
            if not checked:
                dropped = ((tickets < 0) & (km[i] != EMPTY_I32) & live[:, None]).any()
                table.overflowed.logical_or_(dropped)
            states[i] = up.update_agg_state(
                state, tickets.reshape(-1), {c: v.reshape(-1) for c, v in vm[i].items()},
                update_fns[i])
            infos[i] = info
        out = ShardedCarry(carry.tables, tuple(states))
        return (out, infos, events) if collect_events else (out, infos)

    return step


def grow_sharded_carry(carry: ShardedCarry, new_max_local: int,
                       new_capacity: int) -> ShardedCarry:
    """Pause-time growth on every member: widen the bound (pad
    ``key_by_ticket`` with EMPTY and every accumulator with its kind's
    neutral — tickets are stable) and/or migrate the probe table
    (``kernels.table_ops.migrate``: the card's kernel on CUDA members).
    Uniform across members."""
    from repro_torch.kernels import table_ops

    tables, states = [], []
    for t, s in zip(carry.tables, carry.states):
        if new_max_local > t.max_groups:
            pad = t.key_by_ticket.new_full((new_max_local - t.max_groups,), EMPTY_I32)
            t = t._replace(key_by_ticket=torch.cat([t.key_by_ticket, pad]))
            s = up.grow_agg_state(s, new_max_local)
        if new_capacity > t.capacity:
            t = table_ops.migrate(t, new_capacity)
        tables.append(t)
        states.append(s)
    return ShardedCarry(tuple(tables), tuple(states))


def rebucket_sharded_carry(carry: ShardedCarry, mesh, *, load_factor: float = 0.5,
                           max_local: int | None = None, axis: str = "data"):
    """Re-bucket a streamed :class:`ShardedCarry` onto the members of
    ``mesh`` (a mesh, or a sequence of members), whose count may differ —
    the elastic re-mesh primitive (device-loss recovery and
    restore-on-a-new-mesh both lower to it).

    Runs on the host over O(members × max_local) carried state, as in the
    reference: each carried ``(key, partial)`` entry is assigned by the
    exchange merge's rule (``partition_hash(key, new_ndev, seed=7)``),
    entries of one key from several source members fold with their spec's
    merge kind, and each destination gets a fresh table of its sorted
    unique keys, built by the ticket kernel, its partials scattered by the
    segment kernel (their plain versions on the CPU).  The sticky loss
    flags are global semantics, so every destination inherits their OR.
    Returns ``(carry, max_local)``; ``max_local`` keeps a caller-contracted
    local bound, raised when the folded entries need more room."""
    from repro_torch.kernels.ticket_hash import ticket_hash

    members = _members(mesh, axis)
    new_ndev = len(members)
    if new_ndev < 1:
        raise ValueError("rebucket_sharded_carry needs at least one member")
    specs = carry.specs
    kbt = np.stack([_host(t.key_by_ticket) for t in carry.tables]).view(np.uint32)
    counts = [int(c) for c in np.stack([_host(t.count).reshape(()) for t in carry.tables])]
    any_ovf = any(bool(_host(t.overflowed)) for t in carry.tables)
    accs = [np.stack([_host(s.accs[i]) for s in carry.states]) for i in range(len(specs))]
    sel = [(d, c) for d, c in enumerate(counts) if c > 0]
    if sel:
        all_keys = np.concatenate([kbt[d, :c] for d, c in sel])
        all_vals = [np.concatenate([a[d, :c] for d, c in sel]) for a in accs]
    else:
        all_keys = np.zeros((0,), np.uint32)
        all_vals = [np.zeros((0,), np.float32) for _ in accs]
    pid = partition_hash(torch.from_numpy(all_keys.astype(np.int64)), new_ndev,
                         seed=7).numpy()

    per_dev = []
    for d in range(new_ndev):
        mine = pid == d
        uniq, inv = np.unique(all_keys[mine], return_inverse=True)
        folded = []
        for (_, kind), v in zip(specs, all_vals):
            mk = _MERGE_KIND[kind]
            acc = np.full(uniq.shape, float(up.neutral(mk)), np.float32)
            {"sum": np.add, "min": np.minimum, "max": np.maximum}[mk].at(acc, inv, v[mine])
            folded.append(acc)
        per_dev.append((uniq, folded))

    need = max((u.shape[0] for u, _ in per_dev), default=0)
    new_max_local = max(need, max_local or 0, 64)
    cap = table_capacity(new_max_local, load_factor)
    tables, states = [], []
    for m, (uniq, folded) in zip(members, per_dev):
        dev, n = m.device, uniq.shape[0]
        padded = torch.full((new_max_local,), EMPTY_I32, dtype=torch.int32)
        padded[:n] = torch.from_numpy(uniq.view(np.int32).copy())
        tickets, tkeys, ttks, kbt_d, count = ticket_hash(
            padded.to(dev), capacity=cap, max_groups=new_max_local, morsel_size=new_max_local)
        tables.append(tk.TicketTable(
            tkeys.contiguous(), ttks.contiguous(), kbt_d, count.reshape(()),
            torch.tensor(any_ovf, device=dev)))
        fold = _update_fn(dev)
        dev_accs = []
        for (_, kind), v in zip(specs, folded):
            vpad = torch.full((new_max_local,), float(up.neutral(kind)), dtype=torch.float32)
            vpad[:n] = torch.from_numpy(v)
            dev_accs.append(fold(up.init_acc(new_max_local, kind, device=dev), tickets,
                                 vpad.to(dev), kind=_MERGE_KIND[kind]))
        states.append(up.AggState(specs, tuple(dev_accs)))
    return ShardedCarry(tuple(tables), tuple(states)), new_max_local


# ---------------------------------------------------------------------------
# the two finalize merges


def sharded_psum_merge(mesh, axis: str, carry: ShardedCarry, *, max_groups: int):
    """Dense-psum union merge of a streamed :class:`ShardedCarry`: gather
    every member's ``key_by_ticket`` (EMPTY-padded) onto the first member,
    build the union there ONCE with the ticket kernel into a fresh
    ``table_capacity(max_groups)`` table, hand each member its slice of the
    union tickets, scatter each member's partials into union-ticket order
    with the segment kernel, and reduce across members (psum / pmin / pmax)
    onto the first member.

    Pure in the carry, so mid-stream snapshots are free.  Returns
    ``(key_by_ticket, AggState, count, local_ovf, union_ovf)`` on the first
    member: RAW merged accumulators in union-ticket order, the union's
    ticket count (the distinct count even past ``max_groups``, which the
    grow rule reads), the number of members whose sticky loss flag is set,
    and the union's overflow (count past ``max_groups``)."""
    from repro_torch.kernels.ticket_hash import ticket_hash

    members = _members(mesh, axis)
    dst = members[0]
    all_keys = sharding.gather([t.key_by_ticket for t in carry.tables], dst)
    gtickets, _, _, gkbt, gcount = ticket_hash(
        all_keys, capacity=table_capacity(max_groups), max_groups=max_groups,
        morsel_size=all_keys.shape[0])
    mine = sharding.shard(gtickets, members)
    merged = []
    for s, (_, kind) in enumerate(carry.specs):
        mk = _MERGE_KIND[kind]
        parts = [_update_fn(m.device)(up.init_acc(max_groups, kind, device=m.device),
                                      mine[d], carry.states[d].accs[s], kind=mk)
                 for d, m in enumerate(members)]
        merged.append(_REDUCE[mk](parts, dst))
    lovf = sharding.psum([t.overflowed.to(torch.int32).reshape(1) for t in carry.tables],
                         dst).reshape(())
    gcount = gcount.reshape(())
    return gkbt, up.AggState(carry.specs, tuple(merged)), gcount, lovf, gcount > max_groups


def sharded_exchange_merge(mesh, axis: str, carry: ShardedCarry, *, max_groups: int,
                           partition_capacity: int | None = None):
    """All_to_all exchange merge of a streamed :class:`ShardedCarry`: the
    Leis baseline's exchange over each member's LOCAL aggregates.  Every
    accumulator rides the same exchange: a bucket row is ``(key, acc_0 ..
    acc_V)``.  Each member partitions its entries by
    ``partition_hash(key, ndev, seed=7)`` (EMPTY entries to ``ndev``, in
    stable order) into ``ndev`` buckets of ``partition_capacity or max(2 ·
    max_local // ndev, 16)`` rows, counting the entries past a bucket's
    capacity as dropped; after the ``all_to_all`` each owner finishes with
    sort ticketing and a sort-segment fold.

    Returns per-owner lists, owner j's tensors on member j's device:
    ``(keys_p, vals_p, counts_p, overflow_p, local_ovf)`` — ``keys_p[j]``
    its ``key_by_ticket[:max_groups]``, ``vals_p`` a tuple (one per spec) of
    per-owner RAW planes, ``counts_p[j]`` its distinct count,
    ``overflow_p[j]`` the entries member j's buckets dropped — and the
    number of members whose sticky loss flag is set (on the first
    member)."""
    members = _members(mesh, axis)
    ndev = len(members)
    specs = carry.specs
    merge_kinds = tuple(_MERGE_KIND[k] for _, k in specs)
    cap = partition_capacity or max(2 * carry.max_local // ndev, 16)
    bks, bvs, overflow_p = [], [], []
    for table, state, m in zip(carry.tables, carry.states, members):
        allk = table.key_by_ticket
        allv = torch.stack(state.accs, dim=1)  # (max_local, V)
        pid = partition_hash(allk, ndev, seed=7)
        pid = torch.where(allk == EMPTY_I32, torch.full_like(pid, ndev), pid)
        order = torch.argsort(pid, stable=True)
        pk, pp, pv = allk[order], pid[order], allv[order]
        pos = torch.arange(pk.shape[0], device=m.device) - torch.searchsorted(pp, pp)
        kept = (pos < cap) & (pp < ndev)
        overflow_p.append(((pos >= cap) & (pp < ndev)).sum().to(torch.int32))
        dest = torch.where(kept, pp * cap + pos, torch.full_like(pos, ndev * cap))
        bk = torch.full((ndev * cap + 1,), EMPTY_I32, dtype=torch.int32, device=m.device)
        bk[dest] = pk
        neutral_row = torch.tensor([float(up.neutral(mk)) for mk in merge_kinds],
                                   dtype=torch.float32, device=m.device)
        bv = neutral_row.repeat(ndev * cap + 1, 1)
        bv[dest] = pv
        bks.append(bk[:-1].reshape(ndev, cap))
        bvs.append(bv[:-1].reshape(ndev, cap, len(specs)))
    xks = sharding.all_to_all(bks, members)
    xvs = sharding.all_to_all(bvs, members)
    keys_p, counts_p, vals_p = [], [], [[] for _ in specs]
    for m, xk, xv in zip(members, xks, xvs):
        xv = xv.reshape(-1, len(specs))
        tickets, key_by_ticket, cnt = tk.sort_ticketing(xk.reshape(-1))
        for j, ((_, kind), mk) in enumerate(zip(specs, merge_kinds)):
            acc = up.init_acc(max_groups, kind, device=m.device)
            vals_p[j].append(up.sort_segment_update(acc, tickets, xv[:, j], kind=mk))
        keys_p.append(key_by_ticket[:max_groups])
        counts_p.append(cnt)
    lovf = sharding.psum([t.overflowed.to(torch.int32).reshape(1) for t in carry.tables],
                         members[0]).reshape(())
    return keys_p, tuple(vals_p), counts_p, overflow_p, lovf


# ---------------------------------------------------------------------------
# legacy array adapters over GroupByPlan(strategy="sharded")


def concurrent_groupby_sharded(
    mesh,
    keys,
    values=None,
    *,
    kind: str = "count",
    max_groups: int,
    axis: str = "data",
    max_local_groups: int | None = None,
    update: str = "scatter",
    saturation: str = "unchecked",
):
    """Fully concurrent aggregation across the mesh ``axis`` — adapter over
    ``GroupByPlan(strategy="sharded", shard_merge="dense_psum")``.  Pass
    ``saturation="raise"|"grow"`` for checked / recovering bounds (the
    default keeps the legacy unchecked contract)."""
    from repro_torch.engine.executors import make_executor
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
        as_group_result,
    )

    table, _ = arrays_as_table(keys, values)
    agg = AggSpec("count") if kind == "count" else AggSpec(kind, "v")
    plan = GroupByPlan(
        keys=("__key__",), aggs=(agg,), strategy="sharded",
        max_groups=max_groups, saturation=saturation, raw_keys=True,
        execution=ExecutionPolicy(
            mesh=mesh, axis=axis, shard_merge="dense_psum",
            max_local_groups=max_local_groups, update=update,
        ),
    )
    ex = make_executor(plan)
    ex.open()
    ex.consume(table)
    return as_group_result(ex.finalize(), agg)


def partitioned_groupby_sharded(
    mesh,
    keys,
    values=None,
    *,
    kind: str = "count",
    max_groups: int,
    axis: str = "data",
    preagg_capacity: int = 4096,
    partition_capacity: int | None = None,
):
    """Leis-style partitioned aggregation across the mesh ``axis`` — adapter
    over ``GroupByPlan(strategy="sharded", shard_merge="all_to_all")``.
    Returns the legacy per-device layout ``(keys_p, vals_p, counts_p,
    overflow_p)`` (the executor's ``.raw``, concatenated over the members
    on the first one); the plan API's ``finalize`` additionally offers the
    compacted single-table view."""
    from repro_torch.engine.executors import make_executor
    from repro_torch.engine.plan_api import (
        AggSpec,
        ExecutionPolicy,
        GroupByPlan,
        arrays_as_table,
    )

    table, _ = arrays_as_table(keys, values)
    agg = AggSpec("count") if kind == "count" else AggSpec(kind, "v")
    plan = GroupByPlan(
        keys=("__key__",), aggs=(agg,), strategy="sharded",
        max_groups=max_groups, saturation="unchecked", raw_keys=True,
        execution=ExecutionPolicy(
            mesh=mesh, axis=axis, shard_merge="all_to_all",
            preagg_capacity=preagg_capacity,
            partition_capacity=partition_capacity,
        ),
    )
    ex = make_executor(plan)
    ex.open()
    ex.consume(table)
    ex.finalize_raw()  # skips the unified-table compaction nothing here reads
    return ex.raw


__all__ = [
    "ShardedCarry",
    "concurrent_groupby_sharded",
    "grow_sharded_carry",
    "make_sharded_carry",
    "make_sharded_consume_step",
    "partitioned_groupby_sharded",
    "rebucket_sharded_carry",
    "sharded_exchange_merge",
    "sharded_psum_merge",
]
