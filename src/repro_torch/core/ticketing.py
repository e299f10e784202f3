"""Ticketing: map each unique key to a dense integer "ticket" (paper §3.1).

This is the plain PyTorch form of the claim-round protocol of
``repro.core.ticketing``, ticket for ticket: every unresolved lane claims
its probe slot with a scatter-min of its lane id (``scatter_reduce_`` with
``"amin"``), the lowest lane wins, and the winners of a round take the
ticket range ``count + 1 + rank`` ranked by a cumulative sum.  PyTorch has
no ``mode="drop"`` scatter, so lanes that do not claim park on one extra
slot ``C`` of the claim vector.

The merge of per-program fused tables, the migration of a grown table and
the scan route's host pipeline use it; the hot paths ticket inside the
kernels.  :func:`sort_ticketing` (no hash table; the oracle's ticketer) and
:func:`direct_ticketing` (ticket == key for a bounded domain) are the
reference's two other ticketers.  Tickets are
**1-based** in the table (0 = empty), 0-based at the API (-1 = sentinel or
unresolved), as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import EMPTY_I32, slot_hash


class TicketTable(NamedTuple):
    """State of the ticketing hash table.

    Attributes:
      keys:    (capacity,) int32 — key bit patterns, EMPTY_I32 where free.
      tickets: (capacity,) int32 — 1-based tickets, 0 where free.
      key_by_ticket: (max_groups,) int32 — keys in ticket order.
      count:   () int32 — tickets issued so far.
      overflowed: () bool — sticky: tickets were issued past ``max_groups``.
    """

    keys: torch.Tensor
    tickets: torch.Tensor
    key_by_ticket: torch.Tensor
    count: torch.Tensor
    overflowed: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def max_groups(self) -> int:
        return self.key_by_ticket.shape[0]


def make_table(capacity: int, max_groups: int | None = None, *, device=None) -> TicketTable:
    """An empty table of ``capacity`` slots (a power of two)."""
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    if max_groups is None:
        max_groups = capacity
    return TicketTable(
        keys=torch.full((capacity,), EMPTY_I32, dtype=torch.int32, device=device),
        tickets=torch.zeros((capacity,), dtype=torch.int32, device=device),
        key_by_ticket=torch.full((max_groups,), EMPTY_I32, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        overflowed=torch.zeros((), dtype=torch.bool, device=device),
    )


def get_or_insert(table: TicketTable, keys: torch.Tensor, *, seed: int = 0,
                  count_probes: bool = False):
    """Vectorized GET_OR_INSERT over int32 key bit patterns (Algorithm 1 as
    claim rounds).  Pure: the input table is not modified.

    Returns ``(tickets, new_table)`` with 0-based int32 tickets (-1 for
    sentinel keys and for lanes left unresolved by a saturated table after
    ``2 * capacity + 2`` rounds), plus the per-lane probe lengths when
    ``count_probes``."""
    flat = keys.reshape(-1).to(torch.int32)
    dev = flat.device
    n = flat.shape[0]
    capacity = table.capacity
    g = table.max_groups
    mask = capacity - 1
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    max_rounds = 2 * capacity + 2

    tkeys = table.keys.clone()
    ttks = table.tickets.clone()
    kbt = table.key_by_ticket.clone()
    count = int(table.count)
    valid = flat != EMPTY_I32
    slot = slot_hash(flat, capacity, seed=seed)
    active = valid.clone()
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    probe_len = torch.zeros(n, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(active.any()):
        probe_len += active.to(torch.int32)
        probed_key = tkeys[slot]
        probed_tk = ttks[slot]
        hit = active & (probed_tk != 0) & (probed_key == flat)
        out = torch.where(hit, probed_tk.to(torch.int64), out)
        active = active & ~hit
        collide = active & (probed_tk != 0) & (probed_key != flat)
        slot = torch.where(collide, (slot + 1) & mask, slot)
        trying = active & (probed_tk == 0)
        claims = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(0, torch.where(trying, slot, capacity), lane, "amin")
        won = trying & (claims[slot] == lane)
        new_ticket = count + torch.cumsum(won.to(torch.int64), 0)  # count+1+rank
        wslot = slot[won]
        wkey = flat[won]
        wtk = new_ticket[won]
        tkeys[wslot] = wkey
        ttks[wslot] = wtk.to(torch.int32)
        keep = wtk <= g
        kbt[wtk[keep] - 1] = wkey[keep]
        out = torch.where(won, new_ticket, out)
        active = active & ~won
        count += int(wtk.shape[0])
        rounds += 1
    tickets = torch.where(valid & (out > 0), out - 1, torch.full_like(out, -1))
    tickets = tickets.to(torch.int32).reshape(keys.shape)
    count_t = torch.tensor(count, dtype=torch.int32, device=dev)
    new_table = TicketTable(
        tkeys, ttks, kbt, count_t, table.overflowed | (count_t > g)
    )
    if count_probes:
        return tickets, new_table, probe_len.reshape(keys.shape)
    return tickets, new_table


def sort_ticketing(keys: torch.Tensor):
    """Sort-based ticketing (no hash table): sort the keys as unsigned
    32-bit values, mark each first of a run, ticket = prefix count - 1.
    Returns ``(tickets, key_by_ticket, count)``: int32 tickets (-1 for
    sentinel rows, which sort last), ``(n,)`` int32 key bit patterns in
    ticket order (EMPTY_I32 past the count) and a 0-d int32 count."""
    flat = keys.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    dev = flat.device
    u = flat.to(torch.int64) & 0xFFFFFFFF
    order = torch.argsort(u, stable=True)
    su = u[order]
    valid = su != (EMPTY_I32 & 0xFFFFFFFF)
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = su[1:] != su[:-1]
    is_new = valid & first
    ticket_s = torch.cumsum(is_new.to(torch.int64), 0) - 1
    count = is_new.sum().to(torch.int32)
    tickets = torch.empty((n,), dtype=torch.int32, device=dev)
    tickets[order] = torch.where(valid, ticket_s, torch.full_like(ticket_s, -1)).to(torch.int32)
    key_by_ticket = torch.full((n,), EMPTY_I32, dtype=torch.int32, device=dev)
    if n:
        slot = torch.where(is_new, ticket_s, torch.full_like(ticket_s, n - 1))
        key_by_ticket[slot] = torch.where(is_new, flat[order],
                                          torch.full_like(flat, EMPTY_I32))
    return tickets.reshape(keys.shape), key_by_ticket, count


def direct_ticketing(keys: torch.Tensor, domain: int):
    """Perfect-hash ticketing for a bounded key domain: ticket == key for
    keys in ``[0, domain)`` (int32 bit patterns, so keys of 2^31 and up
    are negative and out of it), -1 otherwise.  Returns ``(tickets,
    key_by_ticket, count)`` with ``key_by_ticket = arange(domain)``."""
    flat = keys.reshape(-1).to(torch.int32)
    tickets = torch.where((flat >= 0) & (flat < domain), flat, torch.full_like(flat, -1))
    key_by_ticket = torch.arange(domain, dtype=torch.int32, device=flat.device)
    count = torch.tensor(domain, dtype=torch.int32, device=flat.device)
    return tickets.reshape(keys.shape), key_by_ticket, count


def lookup(table: TicketTable, keys: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Read-only probe: 0-based tickets, -1 for absent or sentinel keys."""
    flat = keys.reshape(-1).to(torch.int32)
    mask = table.capacity - 1
    slot = slot_hash(flat, table.capacity, seed=seed)
    valid = flat != EMPTY_I32
    active = valid.clone()
    out = torch.full(flat.shape, -1, dtype=torch.int32, device=flat.device)
    while bool(active.any()):
        probed_key = table.keys[slot]
        probed_tk = table.tickets[slot]
        hit = active & (probed_tk != 0) & (probed_key == flat)
        miss = active & (probed_tk == 0)
        out = torch.where(hit, probed_tk - 1, out)
        active = active & ~hit & ~miss
        slot = torch.where(active, (slot + 1) & mask, slot)
    return torch.where(valid, out, torch.full_like(out, -1)).reshape(keys.shape)
